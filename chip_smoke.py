#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. Environment: torch and CUDA versions and the card's name and power
   limit (``nvidia-smi``). No CUDA device, or no ``src/repro_torch`` beside
   this script, fails here. The eight CUDA C++ sources are then built from
   the checkout, one ``nvcc`` each, all started together.
2. Kernel vs plain: first, the raw stream lookup every wrapper passes its
   kernel (``build.stream_ptr``) must equal
   ``torch.cuda.current_stream().cuda_stream`` on the default stream, on a
   side stream and inside a CUDA-graph capture. Then each of the four
   loss kernels (``ensemble_kl`` and ``ghm_ce``, forward and backward, all
   CUDA C++) is held against its plain PyTorch version
   on the card, in every mode and, for the backwards, for every non-empty
   subset of the cotangents they can compute, at the main path's shapes
   (K=5, B=128, V=10, f32), at a wide tail case (K=5, B=37, V=32003, f32
   and bf16) and at 20 clients on 100 classes (K=20, B=256, V=100, f32);
   the forwards also at one row of an LM vocabulary (K=5, B=1, V=151936)
   and on planes that start one element off a 16-byte boundary (K=5,
   B=37, V=32000). A second forward call and a CUDA-graph replay must give
   the eager call's bits at every shape, a second backward call and a
   replay at the first two. Then the CUDA C++ attention
   kernels, in f32 (the CUDA-core kernels) and bf16 (the tensor-core
   kernels of ``flash_attention_sm90.cu``, ``_sm90`` below, and the
   CUDA-core ones named by the caller): ``flash_attention_fwd`` at the
   smollm-135m prefill shape (8 prompts × 128 tokens, 9 heads over 3 kv
   heads, hd 64, causal), at its training shape (8 × 256 tokens), at tail
   cases (Sq = Sk = 37, hd 32, with and without window and softcap) and at
   a non-causal windowed case with Sq > Sk, hd 128 and fully-masked rows;
   ``flash_decode`` at the smollm-135m decode shape (8 slots, 16-token
   pages, 12 table entries) and in a windowed ring case; both also at the
   attention shapes of granite-3-2b (32 heads over 8 kv heads, hd 64),
   internlm2-20b (48 over 8, hd 128), qwen3-32b (64 over 8, hd 128),
   mixtral-8x7b (32 over 8, hd 128, window 4096) and qwen3-moe-235b-a22b
   (64 over 4, hd 128): the forward at 8 prompts × 128 tokens, decode at 8
   slots with ragged positions, each timed in bf16; and at the head dims
   of the modality configs: hubert-xlarge (16 over 16, hd 80, non-causal)
   at 4 × 500 frames and a ragged 37, phi-3-vision-4.2b (32 over 32, hd
   96, causal) at its prefill of 8 × (576 + 128), the forward and both
   backward passes, and decode at both head dims in f32 and bf16, each
   timed in bf16 beside SDPA.
   ``flash_decode`` (the split kernel and its combine) also at ragged
   positions from 0 to the last slot, at hd 128 with one query head per kv
   head, and with a table far wider than the live pages; a second call
   must give the same bits. Tolerance, elementwise:
   ``|got − want| ≤ tol·(|want| + max(1, max|want|))`` with tol = 1e-4 for
   f32 outputs and 2^-7 (one bf16 rounding step) for outputs stored in bf16.
   Then the two flash-attention backward kernels (``flash_attention_bwd_dq``
   and ``flash_attention_bwd_dkv``) against ``flash_attention_bwd_ref``, in
   f32 and bf16 (both passes in bf16 through both variants): at the
   smollm-135m training shape (8 × 256 tokens, 9 heads over 3 kv heads,
   hd 64, causal), a tail case (Sq = Sk = 37, hd 32, window 16, softcap
   30) and two non-causal cases with Sq ≠ Sk and hd 128, one windowed with
   fully-masked rows; a second call must give the same bits.
   Times: CUDA events around back-to-back calls of the wrapper (``ms``,
   the table's), and in bf16 also the device alone: calls captured in a
   CUDA graph and replayed (``device_ms``); the two forwards at every
   shape above, the two backwards at the main shape and the wide one in
   f32 and bf16, each in the generator's mode (g_client and g_student, and
   g_client), with the host's share of one call of each of the four at the
   main shape split into its parts, ``flash_attention_fwd`` in both
   variants at the prefill and the training shapes, both backward passes in
   both variants at the training shape and ``flash_decode`` at the decode
   shape. Beside them PyTorch's
   ``scaled_dot_product_attention`` on the same inputs, its forward for the
   forward, its backward (forward+backward less forward) for the backward
   passes: the library times, which the port never calls.
3. Small-input agreement: at a small size, the gradients of the generator
   loss, the distillation loss and the EE loss through the kernels (backend
   "cuda") agree with plain autograd (backend "ref") at the tolerance above;
   one epoch per backend runs to finite losses, and its parameter gaps are
   printed; so does one epoch of each distilling Table 1 baseline (DENSE,
   F-DAFL, F-ADI, FedDF), whose server-parameter gaps must be finite.
   Then the reduced smollm-135m in f32: the gradients of one
   ``lm_loss`` through the attention kernels agree with plain autograd; the
   run must have gone through the CUDA-core kernels only.
4. Training path: ``repro_torch.launch.ofl`` at the paper's image width
   (5×cnn5 clients through the default grouped client bank, cnn5 server,
   32×32×3, 10 classes, synthetic batch 128, gen_iters 30) for a few epochs, with the launch counters reset just
   before and read just after; every loss kernel must have launched, the
   losses must be finite and ``server_acc`` / ``ensemble_acc`` present.
4b. Baselines path: the paper's Table 1 baselines through
   ``repro_torch.launch.ofl.run_method`` on one market built once with
   phase 4's settings: DENSE, F-DAFL, F-ADI and FedDF (3 epochs each), then
   FedAvg and FedENS, then Co-Boosting on the same market. The launch
   counters are reset before each method and read after: the distilling
   baselines must launch the ``ensemble_kl`` forward and backward exactly
   once per distillation step (1+2+3 on the 4-slot ring, 39 batches × 3
   epochs for FedDF) and ``ghm_ce`` never, FedAvg and FedENS nothing. Every
   server parameter evaluated must be finite, ``server_acc`` and
   ``ensemble_acc`` present (FedENS: ``ensemble_acc`` only), DENSE's and
   F-DAFL's losses finite. One line per method: wall seconds, seconds per
   epoch after the first (evaluation after every epoch, its time taken
   out), accuracies and launches; then the accuracies side by side, with
   phase 4's Co-Boosting numbers.
4c. Grouped client bank (``repro_torch.core.client_bank``, the default
   ensemble of phases 4, 4b and 5b). First Table 3's heterogeneous market
   (``benchmarks/table3_hetero.py``): K=10 over cnn5, cnn2, miniresnet, mlp
   and lenet5, random weights from a seed, 32×32×3, 10 classes, batch 128,
   whole and family by family, whole groups and in chunks of 3 clients
   (``--ensemble-scan-chunk 3``): the grouped (K, B, C) stack must stay
   within 1e-4 of the looped one relative to the largest |logit|, and in
   float64 (the same weights and images, cast) the grouped input gradient
   within 1e-10 of the looped one relative to the largest |gradient|: the
   engines compute the same gradient. Each engine's f32 input gradient is
   printed against the float64 loop's, in the max and the L2 norm, not
   gated: ReLU and max-pool make it jump where rounding moves a kink, so
   the f32 loop itself is up to about 1 % from float64 in the max norm at
   this width. The gaps and each engine's f32 ms for the stack and its
   gradient are printed (line ``client bank, Table 3 market``). Then
   Co-Boosting through ``launch.ofl.run_method`` at phase 4's settings,
   K=5, with each engine
   in turns looped, grouped, grouped, looped (evaluation after every
   epoch), then once more each under ``torch.profiler``: every run must
   launch #1–#4 exactly as phase 4 did, reach finite losses and report
   ``server_acc`` and ``ensemble_acc``; printed: s/epoch after the first,
   device ms and device launches an epoch inside ``ofl.epoch``
   (``repro_torch.obs.phases``), its eight largest kernels and the peak
   device memory (line
   ``client bank, Co-Boosting K=5``). The same at K=20 cnn5 (Table 6's
   largest n), looped on the per-client market and grouped on the
   ``--grouped-market`` one, after both markets' build seconds (lines
   ``client bank, K=20 cnn5 market`` and ``client bank, Co-Boosting K=20
   cnn5``).
5. Serving path: smollm-135m at full width (30 layers, d_model 576,
   random weights from a seed). First an f32 check: 4 requests × 16 tokens
   through the paged engine give the same greedy tokens as the static
   dense-cache path (same prefill kernel; its top-2 logit margins must
   exceed 1e-3), through the CUDA-core forward only. Then
   ``repro_torch.launch.serve`` in bf16: continuous batching, paged KV, 16
   requests, prompt 128, 64 new tokens, 8 slots, page size 16, with the
   launch counters reset just before and read just after; both attention
   kernels must have launched, every prefill through the tensor-core
   forward, every request must
   come back with its 64 tokens, and tok/s and p50/p95 latency are printed.
   The run is then repeated under ``torch.profiler`` (device activity
   only) for the device's busy and idle share.
5c. Shared-prefix serving (the radix prefix cache, ``lm_extend`` and
   speculative decoding). First f32 at full width (embedding ×10 as in
   phase 5): ``hot_prefix_stream``, 8 requests, prompt 128 (a 64-token
   shared head on every other prompt), 16 new tokens, 4 slots, page 16,
   arrivals 2 s apart on ``ManualClock``, through four engines: cold,
   prefix cache, prefix cache with the target itself drafting (k = 4) and
   speculative decoding with the ``seed + 1`` drafter, the launch counters
   reset just before each run and read just after. Fatal: every engine's
   tokens equal the cold engine's at every position before the request's
   first near-tie (a cold-path top-2 margin at or below 1e-3, teacher-forced
   through ``lm_forward``; the cold tokens must equal those argmaxes
   there); the prefix engines splice (``spliced_admissions`` > 0) and
   prefill fewer tokens than the cold one; the matched drafter's
   acceptance exceeds 0.5; ``flash_attention_fwd`` launches exactly 30
   layers × (the target's and the drafter's prefill dispatches), on the
   CUDA cores; ``flash_decode`` launches in the prefix-only run and never in
   a speculative one (verify runs through ``lm_extend``). Then bf16 through
   ``repro_torch.launch.serve`` at phase 5's settings with ``--hot-fraction
   0.5``: plain, ``--prefix-cache``, and ``--prefix-cache --spec-decode
   --spec-k 4``, the counters reset when the scheduler's run starts (after
   the launcher's warm-up): every request returns its 64 tokens and the
   launch rule above holds on the tensor cores; the spliced tail's
   last-position logits (head pages from a cold bf16 prefill of another hot
   prompt, tail through ``lm_extend``) stay within 2× the cold bf16
   prefill's own gap to the f32 cold prefill (largest |gap| relative to the
   largest |f32 logit|, phase 6's rule). Printed: tok/s, p50/p95, TTFT,
   prefill tokens, CoW copies, acceptance and the share of tokens equal to
   the plain run on the same stream.
5d. The rest of serving (about 2 minutes). First smollm-135m at full width
   in f32 (embedding ×10) on an 8-request staggered stream (prompts of
   96–160 tokens, 8–16 new tokens, 4 slots, page 16, ``ManualClock``)
   through one engine, through 2 replicas behind ``FleetRouter`` with
   replica 0 a disaggregated pair (``prefill_device="cpu"``: its prefill
   worker runs the plain forward on the host's CPU with its own copy of the
   weights, its decode worker on the card, every admission's sealed pages
   copied across), and through 3 colocated replicas, the launch counters
   reset just before each run and read just after. Fatal: every fleet's
   tokens equal the single engine's at every position before the request's
   first near-tie (as in phase 5c); each fleet uses every replica; the
   pair's prefill worker is on the CPU, its decode worker on the card, and
   it hands off; ``flash_attention_fwd`` launches exactly 30 layers × the
   summed prefill dispatches of the replicas that prefill on the card, on
   the CUDA cores, and ``flash_decode`` launches. Then bf16 through
   ``repro_torch.launch.serve`` at phase 5's settings in turns: one engine,
   ``--replicas 2`` (two colocated replicas), the same again, one engine,
   the counters reset when the scheduler's run starts:
   every request returns its 64 tokens, both replicas admit, the launch
   rule holds on the tensor cores; tok/s of each turn and the medians are
   printed, not gated. Then granite-3-2b at full width and depth (40
   layers, d_model 2048, 32 heads over 8, random weights, embedding ×10):
   the f32 paged engine against the static generator
   (``static_generate``) on 4 requests × 16 tokens, as in phase 5
   (tokens equal, smallest top-2 margin above 1e-3), #5 launching 40 ×
   its prefill dispatches; then the launcher in bf16 at phase 5's
   settings: every request returns its 64 tokens, #5 launches 40 × the
   timed run's prefill dispatches on the tensor cores; printed: tok/s,
   p50/p95, TTFT and the peak device memory. Last internlm2-20b at full
   width cut to 4 of its 48 layers (f32, about 10.8 GB; 48 heads over 8,
   hd 128, head ×10): the f32 engine against the static generator on 4
   requests × 16 tokens. The phase's seconds are printed.
5e. MoE and qk-norm decoders (about 3 minutes). The f32 paged engine
   against the static generator on 4 requests × 16 tokens, each request
   compared before its first near-tie, #5 once a layer for every prefill
   dispatch, at full width with the depth cut to fit f32 on one card
   (head ×10): qwen3-32b at 8 of its 64 layers (qk-norm), mixtral-8x7b at
   4 of 32 and qwen3-moe-235b-a22b at 2 of 94, the two MoE configs at an
   ample capacity factor (E / k: 4.0 and 16.0, nothing drops; the engine
   pads ragged prompts and its idle decode rows are routed too, so with
   drops its tokens may rightly differ from the static path's). Then one
   mixtral MoE layer at full width on 8 × 128 tokens at its own factor
   1.25 and at a tight 0.5 (slots must drop there): einsum and scatter
   dispatch within 1e-4 of the largest |y| with equal router losses, a
   second scatter call bitwise, both against the
   dense ``moe_ref`` within 1e-4 at the ample factor, each timed in f32 and
   bf16. Then a 4-layer mixtral, registered under its own name in this
   process, through ``launch.serve`` in bf16 at phase 5's settings (every
   request returns its 64 tokens, #5 = 4 × the prefill dispatches on the
   tensor cores; tok/s, p50/p95, TTFT, peak memory and, profiled, the
   idle share printed). Then qwen3-32b at full width and depth, its
   weights made directly in bf16 (65.5 GB), through the launcher's paged
   engine on phase 5's stream (``launch.serve.run_continuous``): every
   request returns its tokens, #5 = 64 × the prefill dispatches; tok/s and
   peak memory printed (where the card cannot hold it, the failing peak is
   printed and the depth cut by 8 layers until it fits). Last ``remat``:
   one f32 ``lm_loss`` step of smollm-135m at full width (8 × 256) and of
   mixtral-8x7b at full width, 2 layers (2 × 256), with and without: equal
   loss, every gradient within 1e-6 of its leaf's largest, #5 twice a layer
   with remat and once without; each arm's peak memory is printed.
5f. The recurrent families (about 3 minutes). xlstm-125m at full width
   and depth in f32 (12 layers, 144.9 M parameters, embedding x10): the
   engine (paged requested; an arch without attention runs the dense
   layout) against the static generator on 4 requests x 16 tokens, each
   compared before its first near-tie, #5 and #8 never launched. Then
   ``launch.serve`` in bf16 at phase 5's settings (every request returns
   its 64 tokens, no attention launch; tok/s, p50/p95, TTFT, peak memory)
   and one ``lm_prefill`` of 128 tokens at batch 1 and 8 (ms per prompt
   token on the host clock; the device's idle share, profiled). Then
   ``launch.train`` in bf16 under remat at 4 of the 12 layers (one sLSTM
   group; registered under its own name) at batch 8 x 256 (two scan chunks
   of 128), 2 steps (s/step and tok/s of the second, peak memory, finite
   losses), and one f32
   ``lm_loss`` step at batch 2 x 256 with ``chunked_scan``'s chunk
   checkpoint on and off: the same loss, every gradient within 1e-6 of
   its leaf's largest, each arm's peak memory printed. Then
   jamba-v0.1-52b at full width, 8 of its 32 layers (one interleave group,
   13.30 B parameters, 53.2 GB) in f32 at an ample capacity factor 8.0
   (E / k), head x10: the paged engine (attention pages and per-slot
   Mamba carries) against the static generator on ragged prompts of 128,
   97, 113 and 77 tokens (a recurrent arch prefills at the prompt's own
   length, so #5 runs unpadded), each compared before its first
   near-tie; #5 launches once an attention layer for every prefill
   dispatch. Last jamba in bf16 at the deepest multiple of 8 layers that
   fits, its weights made in bf16, through the launcher's engine on phase
   5's stream (``launch.serve.run_continuous``): every request returns its
   tokens, #5 = attention layers x prefills; tok/s, p50/p95, TTFT, peak
   memory, and one prefill of 8 x 128 tokens timed as above.
5g. The audio-encoder and VLM families (phase budget 150 s).
   hubert-xlarge at full width and depth in f32 (48 layers, 0.95 B
   parameters, 16 heads at hd 80, non-causal, GELU MLP, 504-way codebook
   head): one ``lm_loss`` step on 4 × 500 frames (10 s of audio at 20 ms a
   frame, features from a seed) through the kernels against plain
   autograd: the loss within 1e-5 relative, every gradient within 1e-3
   of its leaf's largest; #5 twice a layer (remat), #6 and #7 once. Then
   10 AdamW steps with bf16 activations on 8 × 500 frames through
   ``runtime.steps``' train step under remat (s/step, frames/s, peak
   memory, launches; finite losses). phi-3-vision-4.2b at full width and
   depth in f32 (3.82 B parameters, 15.3 GB; head ×10): ``static_generate``
   on 4 prompts of 128 tokens after the seeded 576-patch prefix, 64
   greedy tokens, through #5 against the plain attention, each prompt
   compared before its first near-tie (as in phase 5c); #5 once a layer,
   #8 never (the static path decodes densely). Then ``launch.serve
   --engine static --batch 8 --prompt-len 128 --gen 64`` in bf16 (tok/s,
   peak memory, #5 = 32 × 2 runs) and one bf16 prefill of 8 × 704
   positions (ms, host clock). Last ``launch.train`` at full width in bf16
   with AdamW, 8 × 256 text tokens after 576 patches, 5 steps, at the
   deepest multiple of 8 layers that fits AdamW's f32 state (the depth is
   printed): finite losses, #5 twice a layer a step, #6 and #7 once.
5h. One model over a device mesh (``repro_torch.sharding``,
   ``repro_torch.launch.mesh``), in this process as a world of one (NCCL,
   a ``file://`` rendezvous in a temp dir): the degenerate topology on
   one card (``make_fleet_mesh(1)``, ``replica_meshes``,
   ``disagg_submeshes``: one (1, 1) replica, its halves the same mesh);
   then ``ServeEngine(mesh=make_host_mesh())`` for smollm-135m at full
   width in f32 (head ×10), 4 requests × 16 tokens: its tokens equal the
   meshless engine's on every position, and #5 and #8 ran through the
   ``local_map`` route (both counters and the route's calls above 0).
   Then bf16 through ``launch.serve.run_continuous`` at phase 5's
   settings, meshless then sharded: tok/s of each, printed, not gated.
   Last the train step at full width under the 1×1 mesh: 3 AdamW steps
   in f32 on 8 × 256 tokens, its losses within 1e-5 relative of the
   meshless step's; then bf16 s/step, meshless then sharded, #5–#7
   launched through the route. DTensor places every leaf whole on one
   card, so the phase shows the route's host cost, not a split.
5i. The sharded fleet's pieces one card can run (a world of one; a
   multi-rank split needs one card a rank, so it is held on the CPU by
   gloo ranks, ``tests/test_torch_mesh_fleet.py``). (a) The cross-mesh
   pair: smollm-135m at full width in f32 (head ×10), paged, 4 requests ×
   16 tokens, ``ServeEngine(mesh=d, prefill_mesh=p)`` on two distinct
   1×1 meshes over this rank, so that every admission takes the
   cross-mesh handoff (the sealed burst's bytes in one broadcast, placed
   by the decode worker's specs): its tokens equal the colocated meshless
   engine's before each request's first near-tie (as in phase 5c),
   ``handoffs`` above 0, #5 and #8 through the ``local_map`` route. (b)
   ``launch.serve`` in bf16 on a world of one, 8 requests, prompt 128, 16
   new tokens: ``--mesh multipod --replicas 1`` (2 colocated replicas,
   each admitting) and ``--disagg`` (a colocated pair): every request
   returns its tokens. (c) Co-Boosting on phase 4's market (2 epochs)
   under ``mesh_context`` of the 1×1 mesh, the grouped bank's client
   axis split as it always is under a mesh, against the meshless run on the same seed,
   both on cuDNN's deterministic algorithms: #1–#4 launch exactly as
   meshless, every forward through ``on_local_shards`` (the route's
   ``ensemble_kl`` and ``ghm_ce`` calls equal #1's and #3's launches, the
   bank's above 0); ``w`` within 1e-6, the server's and the generator's
   parameters within 1e-5; a second meshless run gives the first one's
   bits; s/epoch of the sharded run and of the second meshless run
   printed, with the card's name and power limit.
5b. Telemetry (``repro_torch.obs``): phase 4's Co-Boosting run, then
   phase 5's serving run, each through its launcher with
   ``--metrics-out``, ``--trace-out`` and ``--profile-dir`` into a
   temporary directory, the launch counters reset just before each and
   read just after. Fatal: the artifacts must pass
   ``repro_torch.obs.validate`` (``--train`` for Co-Boosting); the
   ``ofl.*`` counters must match the settings (3 epochs, 90 generator
   steps, 3 EE steps, 1+2+3 distillation steps on the 4-slot ring); the
   launch counts must equal phase 4's and phase 5's; ``host_syncs`` must
   equal ``decode_chunks`` and phase 5's counts, with 16 observations in
   each request histogram; and the three Algorithm 1 phases
   (``ofl.gen.boost``, ``ofl.ee.weight_search``, ``ofl.kd``) must cover at
   least 90 % of the device time launched inside the ``ofl.epoch`` spans,
   each kernel attributed by launch correlation
   (``repro_torch.obs.phases``); their device ms an epoch are printed.
   Printed, not fatal: s/epoch (the ``ofl.epoch`` spans after the first)
   with telemetry on, unprofiled against profiled (the profiler's cost),
   and serving tok/s with telemetry off and on (metrics and spans, no
   profiler), one turn each, off then on.
6. LM training path: one step of smollm-135m at full width, whose
   gradients through the kernels are held against plain autograd: in f32
   through the CUDA-core kernels (the largest gap relative to each leaf's
   largest gradient is printed, and must stay below 1e-3), then in bf16
   through the tensor-core ones (the gap is printed, and must stay within
   2× the gap between plain autograd in bf16 and in f32: the kernels round
   P and dS to bf16, which may move the gradients no more than bf16
   activations do); then
   ``repro_torch.launch.train`` at full width in bf16 with AdamW (batch 8,
   seq 256, 30 steps), under ``remat`` (the config's default), with the
   launch counters reset just before and read just after: both backward
   kernels must each launch 30 layers × 30 steps times and the forward
   twice that (each layer's recompute in the backward pass), all on the
   tensor cores, every loss must be finite and the last-10 mean below the
   first-10 mean; s/step, tokens/s after the first step and the peak
   device memory are printed, then the same for the same run without
   remat (smollm-135m registered with ``remat=False`` under its own name).
6b. The dry-run (``repro_torch.launch.dryrun``, about 30 s): (a) two
   processes at once, ``--arch smollm-135m --multi-pod single`` (the four
   shapes at full width on the 16x16 mesh, rank 0 of a one-process fake
   world of 256) and the same with ``--coboost 4 --shape train_4k``: every
   record ``ok`` but ``long_500k``, a ``skip`` with the reference's reason;
   the seconds are printed. (b) Phase 6's program counted meshless
   (smollm-135m at full width, 8 × 256, bf16, AdamW, remat) and held to
   phase 6's run: the kernel calls a step under each of the six training
   launch counters equal phase 6's launches over its steps; the aten FLOPs
   equal ``FlopCounterMode``'s over one real step on the card; the bound
   is no more than phase 6's s/step (the ratio is printed); the peak is
   within 0.9–1.1× of phase 6's ``max_memory_allocated``.
7. LM distillation path: ``repro_torch.launch.distill_llm`` at full width
   (K = 3 clients, 8 epochs of DHS, EE and distillation): ``kd`` finite at
   every epoch, ``w`` summing to 1, and both backward kernels launched (DHS
   differentiates the clients, distillation the server), all on the
   tensor cores.
8. Summary: a ``phase seconds: {...}`` line (every phase above, in the
   order run), a ``kernels: {...}`` line (with phase 5i's launches of
   #1–#4 on the mesh and its ``local_map`` calls), the JSON kernel table,
   and last the ``{"ok": true, "device": {...}}`` line.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MAIN = dict(k=5, b=128, v=10)
WIDE = dict(k=5, b=37, v=32003)
CLIENTS20 = dict(k=20, b=256, v=100)  # the paper's client sweep goes to 20
LM_ROW = dict(k=5, b=1, v=151936)  # one row of an LM vocabulary
UNALIGNED = dict(k=5, b=37, v=32000, offset=1)  # every plane one element off a 16-byte boundary
REPLACES = {
    "ensemble_kl_fwd": "src/repro/kernels/ensemble_kl/kernel.py:217",
    "ensemble_kl_bwd": "src/repro/kernels/ensemble_kl/kernel.py:144",
    "ghm_ce_fwd": "src/repro/kernels/ghm_ce/kernel.py:211",
    "ghm_ce_bwd": "src/repro/kernels/ghm_ce/kernel.py:143",
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:335",
    "flash_attention_fwd_sm90": "src/repro/kernels/flash_attention/kernel.py:335",
    "flash_attention_bwd_dq": "src/repro/kernels/flash_attention/kernel.py:295",
    "flash_attention_bwd_dq_sm90": "src/repro/kernels/flash_attention/kernel.py:295",
    "flash_attention_bwd_dkv": "src/repro/kernels/flash_attention/kernel.py:314",
    "flash_attention_bwd_dkv_sm90": "src/repro/kernels/flash_attention/kernel.py:314",
    "flash_decode": "src/repro/kernels/flash_decode/kernel.py:109",
}
LOSS_KERNELS = ("ensemble_kl_fwd", "ensemble_kl_bwd", "ghm_ce_fwd", "ghm_ce_bwd")
# the op counters (every launch of the op) and their tensor-core variants,
# which serve bf16; the CUDA-core kernels serve f32
SM90 = {
    "flash_attention_fwd": "flash_attention_fwd_sm90",
    "flash_attention_bwd_dq": "flash_attention_bwd_dq_sm90",
    "flash_attention_bwd_dkv": "flash_attention_bwd_dkv_sm90",
}
ATTN_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_sm90", "flash_decode")
BWD_KERNELS = (
    "flash_attention_bwd_dq", "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_sm90",
)
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_sm90") + BWD_KERNELS
SOURCES = {
    "ensemble_kl_fwd": "src/repro_torch/kernels/ensemble_kl/ensemble_kl_fwd.cu",
    "ensemble_kl_bwd": "src/repro_torch/kernels/ensemble_kl/ensemble_kl_bwd.cu",
    "ghm_ce_fwd": "src/repro_torch/kernels/ghm_ce/ghm_ce_fwd.cu",
    "ghm_ce_bwd": "src/repro_torch/kernels/ghm_ce/ghm_ce_bwd.cu",
    "flash_attention_fwd": "src/repro_torch/kernels/flash_attention/flash_attention.cu",
    "flash_attention_fwd_sm90": "src/repro_torch/kernels/flash_attention/flash_attention_sm90.cu",
    "flash_attention_bwd_dq": "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu",
    "flash_attention_bwd_dq_sm90": "src/repro_torch/kernels/flash_attention/flash_attention_sm90.cu",
    "flash_attention_bwd_dkv": "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu",
    "flash_attention_bwd_dkv_sm90": "src/repro_torch/kernels/flash_attention/flash_attention_sm90.cu",
    "flash_decode": "src/repro_torch/kernels/flash_decode/flash_decode.cu",
}
ROUTES = {n: "cuda" for n in REPLACES}

# the Co-Boosting training path (phase 4) and the baselines on its market (phase 4b):
# the paper's image width, time-bound knobs cut
OFL_ARGV = [
    "--clients", "5", "--classes", "10", "--image", "32", "--batch", "128", "--gen-iters", "30",
    "--epochs", "3", "--local-epochs", "2", "--per-class", "500", "--server-arch", "cnn5", "--device", "cuda",
]
# the paper's Table 1 baselines that distill (each sweep through ensemble_kl #1 and #2)
DISTILLING = ("dense", "f_dafl", "f_adi", "feddf")
# phase 4c: Table 3's heterogeneous market (benchmarks/table3_hetero.py:8,16), K=10 over the five
# families, grouped against looped at these gaps relative to the largest value (the f32 stack; the
# input gradient in float64), also in chunks of BANK_CHUNK clients; then Co-Boosting with each engine in turns, at K=5 (phase 4's
# market) and at K=20 cnn5 (Table 6's largest n, benchmarks/table6_clients.py:13)
HETERO_ARCHS = ("cnn5", "cnn2", "miniresnet", "mlp", "lenet5")
BANK_TOL = 1e-4
BANK_TOL_F64 = 1e-10
BANK_CHUNK = 3
BANK_TURNS = ("looped", "grouped", "grouped", "looped")

# the attention heads (H, KH, hd) of the configs served besides smollm-135m:
# granite-3-2b (a GQA group of 4), internlm2-20b (6, hd 128), qwen3-32b (8),
# mixtral-8x7b (4, window 4096) and qwen3-moe-235b-a22b (16)
ARCH_HEADS = {"granite-3-2b": (32, 8, 64), "internlm2-20b": (48, 8, 128), "qwen3-32b": (64, 8, 128),
              "mixtral-8x7b": (32, 8, 128), "qwen3-moe-235b-a22b": (64, 4, 128)}
ARCH_WINDOW = {"mixtral-8x7b": 4096}
# serving: smollm-135m at full width
SERVE = dict(requests=16, prompt=128, gen=64, slots=8, page=16)
SERVE_ARGV = [
    "--arch", "smollm-135m", "--engine", "continuous", "--kv-layout", "paged",
    "--requests", str(SERVE["requests"]), "--prompt-len", str(SERVE["prompt"]), "--gen", str(SERVE["gen"]),
    "--max-slots", str(SERVE["slots"]), "--page-size", str(SERVE["page"]), "--device", "cuda",
]
# phase 5c: hot-prefix traffic, f32 through four engines at full width, then
# bf16 through the launcher at phase 5's settings
HOT = dict(requests=8, prompt=128, gen=16, slots=4, page=16, shared=0.5, spec_k=4)
HOT_FLAGS = (["--hot-fraction", "0.5"], ["--hot-fraction", "0.5", "--prefix-cache"],
             ["--hot-fraction", "0.5", "--prefix-cache", "--spec-decode", "--spec-k", "4"])
NEAR_TIE = 1e-3
# phase 5d: smollm-135m in f32 on a staggered stream through one engine and
# two fleets (arms: each replica's prefill device, None = colocated; replica
# 0 of n2 prefills on the CPU and decodes on the card), then the launcher
# with --replicas 2; granite-3-2b at full depth; internlm2-20b cut to
# INTERNLM2_LAYERS of its 48 layers (f32 fits one card)
FLEET = dict(requests=8, prompt=(96, 161), budget=(8, 17), slots=4, max_seq=176,
             arms={"single": (None,), "n2, replica 0 prefill on the CPU": ("cpu", None),
                   "n3 colocated": (None, None, None)})
INTERNLM2_LAYERS = 4
# the smallest share of the device time launched inside the ofl.epoch spans
# that the three Algorithm 1 phase ranges must cover (phase 5b)
PHASE_COVERAGE = 0.9
# phase 5h: the sharded engine and train step under the 1x1 mesh
MESH_TURNS = ("meshless", "sharded")
MESH_TRAIN = dict(batch=8, seq=256, steps=3)
# phase 5i: the cross-mesh pair (f32, full width), the launcher's fleet on a
# world of one (bf16), Co-Boosting on phase 4's market under the 1x1 mesh
FLEET_PAIR = dict(requests=4, gen=16)
FLEET_LAUNCH = dict(requests=8, prompt=128, gen=16)
MESH_COBOOST = dict(epochs=2)
# phase 5b's serving runs with telemetry off and on (metrics and spans), in
# turns: host-bound tok/s spreads between runs, and one turn a side is all
# the script's time limit leaves room for
SERVE_TURNS = ("off", "on")
# LM training: smollm-135m at full width, under remat (the config's default:
# the attention forward launches twice a layer a step, its forward and its
# recompute in the backward pass)
TRAIN = dict(batch=8, seq=256, steps=30, layers=30)
# phase 5e: the MoE and qk-norm decoders at full width, the depth of the f32
# engine checks cut to fit one card (layers), at an ample capacity factor
# (E / k: a group's tokens all fit, nothing drops) where the engine is held
# to the static generator; mixtral's dispatches also at its own factor 1.25
MOE_CHECKS = {"qwen3-32b": dict(layers=8, factor=None), "mixtral-8x7b": dict(layers=4, factor=4.0),
              "qwen3-moe-235b-a22b": dict(layers=2, factor=16.0)}
MIXTRAL_SERVED_LAYERS = 4  # the timed bf16 mixtral-8x7b run through launch.serve
DISPATCH = dict(batch=8, seq=128)  # one prefill-shaped input for the dispatch check
REMAT_MIXTRAL = dict(layers=2, batch=2, seq=256)
# phase 5f: the recurrent families. xlstm-125m training at batch 8 x 256 (two
# scan chunks of 128) and the chunk-checkpoint check at batch 2; jamba's f32
# engine check cut to one interleave group of 8 layers (13.3 B parameters,
# 53.2 GB), at an ample capacity factor (E / k) on ragged prompts
RECURRENT_TRAIN = dict(batch=8, seq=256, steps=2, check_batch=2, layers=4)
RECURRENT_JAMBA = dict(layers=8, factor=8.0, lens=(128, 97, 113, 77))
# phase 5g and its phase-2 shapes: hubert-xlarge (16/16 heads, hd 80, non-causal) at the f32 check's
# 4 x 500 frames (10 s of audio at 20 ms a frame), phi-3-vision-4.2b (32/32, hd 96, causal) at the
# launcher's prefill of 8 x (576 patches + 128 tokens)
MODALITY_ATTN = {"hubert-xlarge": dict(name="4x500 frames", shape=(4, 500, 500, 16, 16, 80), causal=False),
                 "phi-3-vision-4.2b": dict(name="prefill 8x704", shape=(8, 704, 704, 32, 32, 96), causal=True)}
HUBERT = dict(batch=4, frames=500, train_batch=8, steps=10)
PHI = dict(prompts=4, prompt=128, gen=64, batch=8, train_batch=8, train_seq=256, train_steps=5)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phase 1


def environment():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    from repro_torch.utils.device import disable_tf32

    disable_tf32()
    from repro_torch.kernels.build import build_cuda_libraries
    from repro_torch.kernels.ensemble_kl.kernel import BWD_SOURCE as KL_BWD_SOURCE
    from repro_torch.kernels.ensemble_kl.kernel import FWD_SOURCE as KL_FWD_SOURCE
    from repro_torch.kernels.flash_attention.kernel import BWD_SOURCE as FA_BWD_SOURCE
    from repro_torch.kernels.flash_attention.kernel import SM90_SOURCE as FA_SM90_SOURCE
    from repro_torch.kernels.flash_attention.kernel import SOURCE as FA_SOURCE
    from repro_torch.kernels.flash_decode.kernel import SOURCE as FD_SOURCE
    from repro_torch.kernels.ghm_ce.kernel import BWD_SOURCE as CE_BWD_SOURCE
    from repro_torch.kernels.ghm_ce.kernel import FWD_SOURCE as CE_FWD_SOURCE

    t0 = time.perf_counter()
    build_cuda_libraries([FA_SOURCE, FA_BWD_SOURCE, FA_SM90_SOURCE, FD_SOURCE, KL_FWD_SOURCE, KL_BWD_SOURCE,
                          CE_FWD_SOURCE, CE_BWD_SOURCE])
    print(f"built the CUDA kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    return smi


# ---------------------------------------------------------------------------
# phase 2


def _case(k, b, v, dtype, seed, device, offset=0):
    """Logits, weights, labels and a row cotangent; with ``offset``, the
    logits are views that start that many elements into their storage."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    cl = (torch.randn(k * b * v + offset, generator=g) * 2).to(dtype).to(device)[offset:].view(k, b, v)
    st = (torch.randn(b * v + offset, generator=g) * 2).to(dtype).to(device)[offset:].view(b, v)
    w = torch.softmax(torch.randn((k,), generator=g), 0)
    labels = torch.randint(0, v, (b,), generator=g)
    ct = torch.randn((b,), generator=g)
    return [cl, st] + [t.to(device) for t in (w, labels, ct)]


def _err(name, got, want):
    """Largest abs error; fails past the stated tolerance."""
    import torch

    tol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-4
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output not finite")
    diff = (got - want).abs()
    bound = tol * (want.abs() + max(1.0, float(want.abs().max())))
    if not bool((diff <= bound).all()):
        fail(f"{name}: max abs err {float(diff.max()):.3e} beyond tolerance {tol:g}")
    return float(diff.max())


def _time_ms(fn, iters=200, warmup=20):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, reps=20, iters=10):
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed ``iters`` times between CUDA events, so the host's cost per
    call (Python, checks, the launch itself) is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graph asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _host_ms(fn, iters=2000):
    """Host time per call: the host clock around back-to-back calls (the
    device keeps up with a few-microsecond kernel), then a synchronise."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def loss_host_split(cl, st, w, labels, ct, out, lse_t, lse_s, lse, ly):
    """Where the host's time goes in one call of each loss wrapper at the
    main shape, the backwards in the generator's mode: the argument checks,
    the output allocations, the stream lookup and the ``ctypes`` launch,
    each timed alone, beside the whole call; ``rest`` is what the wrapper's
    own Python adds."""
    import torch

    from repro_torch.kernels.build import loss_bwd_geometry, loss_fwd_geometry, stream_ptr
    from repro_torch.kernels.ensemble_kl import kernel as klk
    from repro_torch.kernels.ghm_ce import kernel as cek

    k, b, v = cl.shape
    blocks, vec, _ = loss_bwd_geometry(b * v, cl.element_size(), True)
    geo = loss_fwd_geometry(b, v, cl.element_size(), True)
    if geo.splits != 1:
        fail(f"the main shape's forward splits its rows: {geo}")
    fwd_geo = (geo.vec, geo.lanes, geo.splits, geo.span, geo.blocks)
    res = torch.empty((3, b), dtype=torch.float32, device=w.device)
    g_cl, g_st = torch.empty_like(cl), torch.empty_like(st)
    label_code = cek.LABEL_CODES[labels.dtype]
    args = {
        "ensemble_kl_fwd": (cl.data_ptr(), st.data_ptr(), w.data_ptr(), res.data_ptr(), None, None, k, b, v, 4.0, 0,
                            0, *fwd_geo),
        "ensemble_kl_bwd": (cl.data_ptr(), st.data_ptr(), w.data_ptr(), ct.data_ptr(), out.data_ptr(),
                            lse_t.data_ptr(), lse_s.data_ptr(), g_cl.data_ptr(), g_st.data_ptr(), None, None, None, k,
                            b, v, 4.0, 0, 0, vec, blocks),
        "ghm_ce_fwd": (cl.data_ptr(), labels.data_ptr(), w.data_ptr(), res.data_ptr(), None, None, k, b, v, 1, 0,
                       label_code, *fwd_geo),
        "ghm_ce_bwd": (cl.data_ptr(), labels.data_ptr(), w.data_ptr(), ct.data_ptr(), lse.data_ptr(), ly.data_ptr(),
                       g_cl.data_ptr(), None, None, None, k, b, v, 1, 0, label_code, vec, blocks),
    }
    libs = {"ensemble_kl_fwd": klk._fwd_lib(), "ensemble_kl_bwd": klk._bwd_lib(), "ghm_ce_fwd": cek._fwd_lib(),
            "ghm_ce_bwd": cek._bwd_lib()}
    stream = stream_ptr(w)
    parts = {
        "ensemble_kl_fwd": {
            "call": lambda: klk.ensemble_kl_fwd(cl, st, w, 4.0),
            "checks": lambda: klk._check_inputs("ensemble_kl_fwd", cl, st, w),
            "outputs": lambda: torch.empty((3, b), dtype=torch.float32, device=w.device),
        },
        "ensemble_kl_bwd": {
            "call": lambda: klk.ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, 4.0, needs=(True, True, False)),
            "checks": lambda: klk._check_bwd(cl, st, w, ct, out, lse_t, lse_s),
            "outputs": lambda: (torch.empty_like(cl), torch.empty_like(st)),
        },
        "ghm_ce_fwd": {
            "call": lambda: cek.ghm_ce_fwd(cl, labels, w, True),
            "checks": lambda: cek._check_inputs("ghm_ce_fwd", cl, labels, w),
            "outputs": lambda: torch.empty((3, b), dtype=torch.float32, device=w.device),
        },
        "ghm_ce_bwd": {
            "call": lambda: cek.ghm_ce_bwd(cl, labels, w, ct, lse, ly, True, True, needs=(True, False)),
            "checks": lambda: cek._check_bwd(cl, labels, w, ct, lse, ly),
            "outputs": lambda: torch.empty_like(cl),
        },
    }
    for name, fns in parts.items():
        fn, a = libs[name], args[name]
        fns["stream"] = lambda: stream_ptr(w)
        fns["launch"] = lambda: fn(*a, stream)
        t = {part: _host_ms(f) for part, f in fns.items()}
        t["rest"] = t["call"] - sum(t[q] for q in ("checks", "outputs", "stream", "launch"))
        mode = ", generator's mode" if name.endswith("bwd") else ""
        print(f"host split {name} (main shape{mode}), ms per call: " + json.dumps(t), flush=True)


def check_stream_lookup():
    """The raw stream lookup every ``ctypes`` wrapper passes its kernel
    equals ``torch.cuda.current_stream().cuda_stream`` on the default
    stream, on a side stream and inside a CUDA-graph capture, and costs
    less per call."""
    import torch

    from repro_torch.kernels.build import stream_ptr

    x = torch.zeros(1, device="cuda")

    def same(where):
        got, want = stream_ptr(x), torch.cuda.current_stream().cuda_stream
        if got != want:
            fail(f"stream_ptr gave {got:#x} on {where}, torch.cuda.current_stream() {want:#x}")

    same("the default stream")
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        same("a side stream")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        same("a CUDA-graph capture")
        x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    t = {"stream_ptr": _host_ms(lambda: stream_ptr(x)),
         "current_stream": _host_ms(lambda: torch.cuda.current_stream(x.device).cuda_stream)}
    print("stream lookup agrees on the default stream, a side stream and in a graph capture; ms per call: "
          + json.dumps(t), flush=True)


def _same_bits(name, a, b):
    import torch

    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{name}: gave other bits")


def _replayed(fn):
    """``(eager outputs, outputs of the same call captured in a CUDA graph
    and replayed twice)``."""
    import torch

    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return eager, captured


def kernels_vs_plain():
    """The four loss kernels against their plain versions: the forwards in
    every mode at every shape, the backwards in every mode and for every
    non-empty subset of the cotangents they can compute, at the main shape,
    at the wide vocabulary in f32 and bf16, and at 20 clients on 100
    classes. A second forward call and a CUDA-graph replay give the eager
    call's bits at every shape; a second backward call and a replay at the
    main shape and the wide one in f32. Times per call and on the device
    alone: the forwards at every shape, the backwards at the main and wide
    shapes in the mode the main path calls them in most (the generator's:
    g_client and g_student, g_client)."""
    import torch

    from repro_torch.kernels.ensemble_kl.kernel import ensemble_kl_bwd, ensemble_kl_fwd
    from repro_torch.kernels.ensemble_kl.ref import ensemble_kl_bwd_ref, ensemble_kl_fwd_ref
    from repro_torch.kernels.ghm_ce.kernel import ghm_ce_bwd, ghm_ce_fwd
    from repro_torch.kernels.ghm_ce.ref import ghm_ce_bwd_ref, ghm_ce_fwd_ref
    from repro_torch.kernels.kernel_cost import bound_ms, loss_work

    check_stream_lookup()
    dev = torch.device("cuda")
    errs = {n: 0.0 for n in LOSS_KERNELS}
    timing = {}
    subsets_kl = [(a, b, c) for a in (False, True) for b in (False, True) for c in (False, True) if a or b or c]
    subsets_ce = [(True, False), (False, True), (True, True)]
    # (shape, dtype, whether the backwards run there too)
    shapes = [(MAIN, torch.float32, True), (WIDE, torch.float32, True), (WIDE, torch.bfloat16, True),
              (CLIENTS20, torch.float32, True), (LM_ROW, torch.float32, False), (UNALIGNED, torch.float32, False)]
    for si, (shape, dtype, bwd) in enumerate(shapes):
        k, b, v, offset = shape["k"], shape["b"], shape["v"], shape.get("offset", 0)
        cl, st, w, labels, ct = _case(k, b, v, dtype, seed=si, device=dev, offset=offset)
        tag = f"K={k} B={b} V={v} {str(dtype).replace('torch.', '')}" + (f" offset {offset}" if offset else "")
        for temp in (1.0, 4.0):
            got = ensemble_kl_fwd(cl, st, w, temp)
            want = ensemble_kl_fwd_ref(cl, st, w, temp)
            for name_o, a, r in zip(("out", "lse_t", "lse_s"), got, want):
                e = _err(f"ensemble_kl_fwd {tag} T={temp} {name_o}", a, r)
                errs["ensemble_kl_fwd"] = max(errs["ensemble_kl_fwd"], e)
            if not bwd:
                continue
            out, lse_t, lse_s = want
            want = ensemble_kl_bwd_ref(cl, st, w, ct, out, lse_t, lse_s, temp)
            for needs in subsets_kl:
                got = ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, temp, needs=needs)
                for name_o, a, r, x in zip(("g_client", "g_student", "g_w"), got, want, needs):
                    if (a is None) == x:
                        fail(f"ensemble_kl_bwd {tag} T={temp} needs={needs}: {name_o} is {a is None and 'None'}")
                    if x:
                        e = _err(f"ensemble_kl_bwd {tag} T={temp} needs={needs} {name_o}", a, r)
                        errs["ensemble_kl_bwd"] = max(errs["ensemble_kl_bwd"], e)
        for weighted in (True, False):
            want = ghm_ce_fwd_ref(cl, labels, w, weighted)
            for lab in (labels, labels.int()):
                got = ghm_ce_fwd(cl, lab, w, weighted)
                for name_o, a, r in zip(("out", "lse", "ly"), got, want):
                    e = _err(f"ghm_ce_fwd {tag} weighted={weighted} {lab.dtype} labels {name_o}", a, r)
                    errs["ghm_ce_fwd"] = max(errs["ghm_ce_fwd"], e)
            if not bwd:
                continue
            _, lse, ly = want
            for stop in ((True, False) if weighted else (False,)):
                want = ghm_ce_bwd_ref(cl, labels, w, ct, lse, ly, weighted, stop)
                for needs in subsets_ce:
                    got = ghm_ce_bwd(cl, labels, w, ct, lse, ly, weighted, stop, needs=needs)
                    for name_o, a, r, x in zip(("g_client", "g_w"), got, want, needs):
                        if (a is None) == x:
                            fail(f"ghm_ce_bwd {tag} weighted={weighted} stop={stop} needs={needs}: {name_o} wrong")
                        if x:
                            e = _err(f"ghm_ce_bwd {tag} weighted={weighted} stop={stop} needs={needs} {name_o}", a, r)
                            errs["ghm_ce_bwd"] = max(errs["ghm_ce_bwd"], e)
        torch.cuda.synchronize()
        print(f"kernels agree with plain versions at {tag}", flush=True)

        # a second call and a graph replay give the eager call's bits: the
        # forwards everywhere (split rows at the wide shapes), the backwards
        # with every cotangent (g_w across blocks at the wide shape)
        out, lse_t, lse_s = ensemble_kl_fwd_ref(cl, st, w, 4.0)
        _, lse, ly = ghm_ce_fwd_ref(cl, labels, w, True)
        same = {"ensemble_kl_fwd": lambda: ensemble_kl_fwd(cl, st, w, 4.0),
                "ghm_ce_fwd": lambda: ghm_ce_fwd(cl, labels, w, True)}
        if bwd and shape is not CLIENTS20 and dtype == torch.float32:
            same["ensemble_kl_bwd"] = lambda: ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, 4.0)
            same["ghm_ce_bwd"] = lambda: ghm_ce_bwd(cl, labels, w, ct, lse, ly, True, False)
        for name, fn in same.items():
            first = fn()
            _same_bits(f"{name} {tag}, a second call", first, fn())
            _same_bits(f"{name} {tag}, a CUDA-graph replay", *_replayed(fn))
        print(f"{', '.join(same)} at {tag}: a second call and a graph replay give the same bits", flush=True)

        # times: ensemble_kl at T=4, ghm_ce weighted with the difficulty held
        # constant; the backwards in the generator's mode
        gen_kl, gen_ce = (True, True, False), (True, False)
        calls = {
            "ensemble_kl_fwd": (lambda: ensemble_kl_fwd(cl, st, w, 4.0), lambda: ensemble_kl_fwd_ref(cl, st, w, 4.0),
                                None),
            "ensemble_kl_bwd": (
                lambda: ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, 4.0, needs=gen_kl),
                lambda: ensemble_kl_bwd_ref(cl, st, w, ct, out, lse_t, lse_s, 4.0, needs=gen_kl),
                gen_kl,
            ),
            "ghm_ce_fwd": (lambda: ghm_ce_fwd(cl, labels, w, True), lambda: ghm_ce_fwd_ref(cl, labels, w, True), None),
            "ghm_ce_bwd": (
                lambda: ghm_ce_bwd(cl, labels, w, ct, lse, ly, True, True, needs=gen_ce),
                lambda: ghm_ce_bwd_ref(cl, labels, w, ct, lse, ly, True, True, needs=gen_ce),
                gen_ce,
            ),
        }
        if shape is MAIN:
            loss_host_split(cl, st, w, labels, ct, out, lse_t, lse_s, lse, ly)
        for name, (kern, plain, needs) in calls.items():
            if needs is not None and (not bwd or shape is CLIENTS20):
                continue  # the backwards at the main and the wide shapes
            bound, bound_by = bound_ms(*loss_work(name, k, b, v, cl.element_size(), needs))
            timing[(name, tag)] = {
                "ms": _time_ms(kern), "plain_ms": _time_ms(plain),
                "bound_ms": bound, "bound_by": bound_by, "device_ms": _graph_ms(kern),
            }
    for (name, tag), t in timing.items():
        print(f"time {name} {tag}: " + json.dumps(t), flush=True)
    main_tag = f"K={MAIN['k']} B={MAIN['b']} V={MAIN['v']} float32"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    return errs, {n: {k: timing[(n, main_tag)][k] for k in keys} for n in LOSS_KERNELS}


# ---------------------------------------------------------------------------
# phase 2, the attention kernels


def _attn_case(b, sq, sk, h, kh, hd, dtype, seed, device):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    shapes = ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd))
    return [torch.randn(shape, generator=g).to(dtype).to(device) for shape in shapes]


def _decode_case(b, h, kh, hd, ps, w, window, pos, dtype, seed, device):
    """Pages of a full serving pool (every row owns the pages its positions
    cover, the rest of its table points at a scratch page holding NaN).
    Also returns the count of valid cached positions over all rows."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    n_pages = b * w + 1
    kp = torch.randn((n_pages, ps, kh, hd), generator=g)
    vp = torch.randn((n_pages, ps, kh, hd), generator=g)
    kp[-1] = float("nan")
    vp[-1] = float("nan")
    cl = min(window, w * ps) if window else w * ps
    table = torch.full((b, w), n_pages - 1, dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=g).to(torch.int32)
    live = [-(-min(p + 1, cl) // ps) for p in pos]
    for r in range(b):
        table[r, : live[r]] = perm[r * w : r * w + live[r]]
    q = torch.randn((b, h, hd), generator=g)
    ft = lambda t: t.to(dtype).to(device)
    kw = dict(window=window, cache_len=cl)
    keys = sum(min(p + 1, cl) for p in pos)  # the valid positions: all the function reads
    return ft(q), ft(kp), ft(vp), table.to(device), torch.tensor(pos, dtype=torch.int32, device=device), kw, keys


def _lse_err(name, got, want):
    """lse: fully-masked rows are exactly 1e30 in both; the rest as _err."""
    if not bool(((got == 1e30) == (want == 1e30)).all()):
        fail(f"{name}: fully-masked rows differ")
    keep = want != 1e30
    return _err(name, got[keep], want[keep]) if bool(keep.any()) else 0.0


def _sdpa(q, k, v, causal=True):
    """PyTorch's fused attention on the same inputs, in its (B, H, S, hd)
    layout (transposed views), GQA."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)


def attention_kernels_vs_plain():
    """``flash_attention_fwd`` and ``flash_decode`` against their plain
    versions, f32 and bf16. bf16 goes to the tensor-core forward (``_sm90``)
    and, named, to the CUDA-core one as well; f32 to the CUDA-core one.
    Times at the serving prefill and the training shapes: the two variants
    of the forward side by side with SDPA's forward on the same inputs,
    per wrapper call (CUDA events) and on the device alone (CUDA graph)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref_lse
    from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.kernel_cost import attention_fwd_work, bound_ms, decode_work, peak_flops

    dev = torch.device("cuda")
    errs = {n: 0.0 for n in ATTN_KERNELS}
    timing = {}
    n_pre, lb = SERVE["slots"], SERVE["prompt"]
    timed = {"smollm prefill": "prefill", "smollm train": "train", **{f"{a} prefill": f"{a} prefill" for a in ARCH_HEADS},
             **{f"{a} {m['name']}": f"{a} {m['name']}" for a, m in MODALITY_ATTN.items()}}
    attn_cases = [
        ("smollm prefill", (n_pre, lb, lb, 9, 3, 64), dict(causal=True)),
        ("smollm train", (TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], 9, 3, 64), dict(causal=True)),
        ("tail", (2, 37, 37, 4, 2, 32), dict(causal=True)),
        ("tail window+softcap", (2, 37, 37, 4, 2, 32), dict(causal=True, window=8, softcap=30.0)),
        # Sq > Sk, non-causal, window: the rows past the keys + window see none of them
        ("cross hd128 window", (1, 70, 33, 4, 1, 128), dict(causal=False, window=16)),
        # the prefill shapes of the other served configs (ARCH_HEADS), mixtral's with its window
    ] + [(f"{a} prefill", (n_pre, lb, lb) + heads, dict(causal=True, window=ARCH_WINDOW.get(a, 0)))
         for a, heads in ARCH_HEADS.items()
    # hubert-xlarge (hd 80, non-causal) at its batch and at a ragged 37, phi-3-vision-4.2b (hd 96) at its prefill
    ] + [(f"{a} {m['name']}", m["shape"], dict(causal=m["causal"])) for a, m in MODALITY_ATTN.items()] + [
        ("hubert-xlarge ragged 37", (2, 37, 37) + MODALITY_ATTN["hubert-xlarge"]["shape"][3:], dict(causal=False))]
    w_pages = (SERVE["prompt"] + SERVE["gen"]) // SERVE["page"]
    mid = SERVE["prompt"] + SERVE["gen"] // 2
    ragged = [i * (w_pages * SERVE["page"] - 1) // (SERVE["slots"] - 1) for i in range(SERVE["slots"])]  # 0 .. max_seq-1
    decode_cases = [
        ("smollm decode", (SERVE["slots"], 9, 3, 64, SERVE["page"], w_pages, 0, [mid] * SERVE["slots"])),
        ("smollm decode ragged", (SERVE["slots"], 9, 3, 64, SERVE["page"], w_pages, 0, ragged)),
        ("ring", (3, 4, 2, 32, 8, 5, 16, [3, 20, 37])),
        ("hd128 one head per kv head", (2, 8, 8, 128, 64, 3, 0, [0, 150])),
        # max_seq far beyond the positions reached: 11 live entries of 256
        ("smollm decode wide table", (SERVE["slots"], 9, 3, 64, SERVE["page"], 256, 0, [mid] * SERVE["slots"])),
    ] + [(f"{a} decode", (SERVE["slots"], *heads, SERVE["page"], w_pages, ARCH_WINDOW.get(a, 0), ragged))
         for a, heads in ARCH_HEADS.items()
    # #8 at hd 80 and 96: no path launches it (hubert has no decode, phi's static path decodes densely)
    ] + [(f"{a} heads decode", (SERVE["slots"], *m["shape"][3:], SERVE["page"], w_pages, 0, ragged))
         for a, m in MODALITY_ATTN.items()]
    decode_timed = {"smollm decode": "decode", **{f"{a} decode": f"{a} decode" for a in ARCH_HEADS},
                    **{f"{a} heads decode": f"{a} heads decode" for a in MODALITY_ATTN}}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        peak = peak_flops(dtype)
        # bf16: the tensor-core kernel (picked by dtype) and the CUDA-core one (named)
        variants = {None: "flash_attention_fwd"} if dtype == torch.float32 else {
            None: "flash_attention_fwd_sm90", "cuda_core": "flash_attention_fwd"}
        for ci, (tag, shape, kw) in enumerate(attn_cases):
            q, k, v = _attn_case(*shape, dtype, seed=ci, device=dev)
            want_o, want_lse = flash_attention_ref_lse(q, k, v, **kw)
            if tag == "cross hd128 window" and not bool((want_lse == 1e30).any()):
                fail("the cross hd128 window case has no fully-masked row")
            for variant, name in variants.items():
                reset_launch_counts()
                out, lse = flash_attention_fwd(q, k, v, variant=variant, **kw)
                torch.cuda.synchronize()
                if launch_counts()["flash_attention_fwd_sm90"] != int(name == "flash_attention_fwd_sm90"):
                    fail(f"flash_attention_fwd {tag} {dname} variant {variant}: launched {launch_counts()}")
                label = f"{name} {tag} {dname}"
                errs[name] = max(errs[name], _err(label + " out", out, want_o), _lse_err(label + " lse", lse, want_lse))
            if tag not in timed or (dtype == torch.float32 and tag != "smollm prefill"):
                continue
            bound, bound_by = bound_ms(*attention_fwd_work(*shape, q.element_size(), kw["causal"]), peak)
            plain_ms = _time_ms(lambda: flash_attention_ref_lse(q, k, v, **kw), iters=50)
            library = _sdpa(q, k, v, kw["causal"])
            on_device = dtype == torch.bfloat16  # device times for the main paths' dtype
            library_ms, library_dev = _time_ms(library), _graph_ms(library) if on_device else None
            for variant, name in variants.items():
                call = lambda: flash_attention_fwd(q, k, v, variant=variant, **kw)
                timing[(name, timed[tag], dname)] = {
                    "ms": _time_ms(call), "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": library_ms, "device_ms": _graph_ms(call) if on_device else None,
                    "library_device_ms": library_dev,
                }
        for ci, (tag, args) in enumerate(decode_cases):
            q, kp, vp, table, pos, kw, keys = _decode_case(*args, dtype, seed=10 + ci, device=dev)
            out = flash_decode_fwd(q, kp, vp, table, pos, **kw)
            want = flash_decode_ref(q, kp, vp, table, pos, **kw)
            torch.cuda.synchronize()
            errs["flash_decode"] = max(errs["flash_decode"], _err(f"flash_decode {tag} {dname}", out, want))
            if not torch.equal(flash_decode_fwd(q, kp, vp, table, pos, **kw), out):
                fail(f"flash_decode {tag} {dname}: a second call gave other bits")
            if tag in decode_timed:
                b, h, kh, hd = args[:4]
                bound, bound_by = bound_ms(*decode_work(b, h, kh, hd, keys, table.numel(), q.element_size()), peak)
                call = lambda: flash_decode_fwd(q, kp, vp, table, pos, **kw)
                timing[("flash_decode", decode_timed[tag], dname)] = {
                    "ms": _time_ms(call),
                    "plain_ms": _time_ms(lambda: flash_decode_ref(q, kp, vp, table, pos, **kw)),
                    "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
                    "device_ms": _graph_ms(call) if dtype == torch.bfloat16 else None,
                }
        print(f"attention kernels agree with plain versions in {dname}", flush=True)
    # the host's cost of a wrapper call: the tensor-core forward at a toy
    # shape (one block), per call by CUDA events and on the device alone
    q, k, v = _attn_case(1, 64, 64, 1, 1, 64, torch.bfloat16, seed=9, device=dev)
    toy = lambda: flash_attention_fwd(q, k, v)
    print(f"time flash_attention_fwd_sm90 at 1 x 64 tokens, 1 head (the wrapper's host floor): per call "
          f"{_time_ms(toy):.6f} ms, device {_graph_ms(toy):.6f} ms", flush=True)
    for (name, where, dname), t in timing.items():
        print(f"time {name} {where} shape {dname}: " + json.dumps(t), flush=True)
    # the main paths run in bf16: the table takes the forward at the training
    # shape (where its launches are counted) and flash_decode at the decode shape
    table = {n: timing[(n, "train", "bfloat16")] for n in ("flash_attention_fwd", "flash_attention_fwd_sm90")}
    table["flash_decode"] = timing[("flash_decode", "decode", "bfloat16")]
    return errs, {n: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")} for n, t in table.items()}


def _sdpa_bwd(q, k, v, dout, causal=True):
    """PyTorch's fused attention backward on the same inputs (GQA):
    ``(forward+backward, forward)`` callables, timed only."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dt = dout.transpose(1, 2)
    fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    both = lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dt)
    return both, fwd


def attention_bwd_kernels_vs_plain():
    """``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` against
    their plain versions, f32 and bf16 (both passes in bf16 through the
    tensor-core kernels, picked by dtype, and the CUDA-core ones, named), a
    second call bitwise equal; times at the training shape, per wrapper
    call and on the device alone, beside SDPA's backward."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_dkv, flash_attention_bwd_dq
    from repro_torch.kernels.flash_attention.ref import (
        attention_delta,
        flash_attention_bwd_dkv_ref,
        flash_attention_bwd_dq_ref,
        flash_attention_ref_lse,
    )
    from repro_torch.kernels.kernel_cost import attention_bwd_work, bound_ms, peak_flops

    dev = torch.device("cuda")
    errs = {n: 0.0 for n in BWD_KERNELS}
    timing = {}
    cases = [
        ("smollm train", (TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], 9, 3, 64), dict(causal=True)),
        ("tail window+softcap", (2, 37, 37, 4, 2, 32), dict(causal=True, window=16, softcap=30.0)),
        ("cross hd128", (2, 70, 45, 8, 2, 128), dict(causal=False)),
        ("cross hd128 window", (1, 70, 33, 4, 1, 128), dict(causal=False, window=16)),  # fully-masked rows
        # hubert-xlarge (hd 80, non-causal) at its batch and at a ragged 37, phi-3-vision-4.2b (hd 96)
    ] + [(f"{a} {m['name']}", m["shape"], dict(causal=m["causal"])) for a, m in MODALITY_ATTN.items()] + [
        ("hubert-xlarge ragged 37", (2, 37, 37) + MODALITY_ATTN["hubert-xlarge"]["shape"][3:], dict(causal=False))]
    # timed: the training shape in both dtypes, the modality shapes in bf16
    timed = {"smollm train": "training shape", **{f"{a} {m['name']}": f"{a} {m['name']}"
                                                  for a, m in MODALITY_ATTN.items()}}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        peak = peak_flops(dtype)
        # bf16: the tensor-core kernels (picked by dtype) and the CUDA-core ones (named)
        passes = {"dq": {None: "flash_attention_bwd_dq"}, "dkv": {None: "flash_attention_bwd_dkv"}}
        if dtype == torch.bfloat16:
            passes = {w: {None: f"flash_attention_bwd_{w}_sm90", "cuda_core": f"flash_attention_bwd_{w}"} for w in passes}
        fns = {"dq": (flash_attention_bwd_dq, flash_attention_bwd_dq_ref),
               "dkv": (flash_attention_bwd_dkv, flash_attention_bwd_dkv_ref)}
        for ci, (tag, shape, kw) in enumerate(cases):
            q, k, v = _attn_case(*shape, dtype, seed=20 + ci, device=dev)
            g = torch.Generator(device="cpu").manual_seed(30 + ci)
            dout = torch.randn(q.shape, generator=g).to(dtype).to(dev)
            out, lse = flash_attention_ref_lse(q, k, v, **kw)
            delta = attention_delta(out, dout)
            args = (q, k, v, dout, lse, delta)
            name = f"{tag} {dname}"
            for w, variants in passes.items():
                kern, plain = fns[w]
                outs = ("dq",) if w == "dq" else ("dk", "dv")
                as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
                want = as_tuple(plain(*args, **kw))
                for variant, kname in variants.items():
                    reset_launch_counts()
                    got = as_tuple(kern(*args, variant=variant, **kw))
                    torch.cuda.synchronize()
                    if launch_counts()[f"flash_attention_bwd_{w}_sm90"] != int(kname.endswith("_sm90")):
                        fail(f"flash_attention_bwd_{w} {name} variant {variant}: launched {launch_counts()}")
                    for out_name, a, r in zip(outs, got, want):
                        errs[kname] = max(errs[kname], _err(f"{kname} {name} {out_name}", a, r))
                    again = as_tuple(kern(*args, variant=variant, **kw))
                    if not all(torch.equal(a, b) for a, b in zip(again, got)):
                        fail(f"{kname} {name}: a second call gave other bits")
            if tag not in timed or (dtype == torch.float32 and ci != 0):
                continue
            work = {w: attention_bwd_work(w, *shape, q.element_size(), kw["causal"]) for w in ("dq", "dkv")}
            both, fwd = _sdpa_bwd(q, k, v, dout, kw["causal"])
            library = _time_ms(both, iters=50) - _time_ms(fwd, iters=50)
            on_device = dtype == torch.bfloat16  # device times for the main paths' dtype
            library_dev = _graph_ms(both) - _graph_ms(fwd) if on_device else None
            calls = {}
            for w, variants in passes.items():
                kern, plain = fns[w]
                for variant, kname in variants.items():
                    calls[kname] = (w, lambda kern=kern, variant=variant: kern(*args, variant=variant, **kw),
                                    lambda plain=plain: plain(*args, **kw))
            for n, (w, kern, plain) in calls.items():
                bound, bound_by = bound_ms(*work[w], peak)
                timing[(n, timed[tag], dname)] = {
                    "ms": _time_ms(kern, iters=50), "plain_ms": _time_ms(plain, iters=20),
                    "bound_ms": bound, "bound_by": bound_by, "library_ms": library,
                    "device_ms": _graph_ms(kern) if on_device else None, "library_device_ms": library_dev,
                }
        print(f"attention backward kernels agree with plain versions in {dname}, bitwise on a second call", flush=True)
    for (name, where, dname), t in timing.items():
        print(f"time {name} {where} {dname}: " + json.dumps(t), flush=True)
    # the training path runs in bf16: its times go in the table
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return errs, {n: {k: timing[(n, "training shape", "bfloat16")][k] for k in keys} for n in BWD_KERNELS}


def _check_variants(where, counts, dtype):
    """The attention launches of a run in ``dtype``: bf16 runs go through the
    tensor-core kernels only (their counters equal the op counters), f32
    runs through the CUDA-core kernels only; the forward ran at least once."""
    if counts["flash_attention_fwd"] == 0:
        fail(f"{where}: the attention forward never launched")
    for op, variant in SM90.items():
        want = counts[op] if dtype == "bfloat16" else 0
        if counts[variant] != want:
            fail(f"{where} ({dtype}): {variant} launched {counts[variant]} times, expected {want} of {counts[op]} {op}")


# ---------------------------------------------------------------------------
# phase 3


def small_input_agreement():
    """At a small input, every gradient an Algorithm-1 step takes through
    the kernels (backend "cuda") agrees with plain autograd of the plain ops
    (backend "ref"): the generator's (Eq. 8, through the clients, the server
    and both loss kernels), the server's (Eq. 4 on a DHS batch) and the
    ensembling weights' (Eq. 12). Then one whole epoch per backend, whose
    parameter gaps are printed: Adam's first steps and the EE sign step act
    on the signs of gradient components, so rounding-level differences can
    move a parameter by a whole step there, and the epoch is held only to
    finite losses."""
    import dataclasses
    from functools import partial

    import torch

    from repro_torch.config.train import OFLConfig
    from repro_torch.core.buffer import buffer_init
    from repro_torch.core.ensemble import make_logits_all
    from repro_torch.core.epoch import distill_schedule, make_coboost_epoch, make_kd_loss
    from repro_torch.core.hard_samples import diversify
    from repro_torch.core.hardness import generator_loss
    from repro_torch.core.weight_search import weight_grad
    from repro_torch.models.cnn import cnn_apply, init_cnn
    from repro_torch.models.generator import image_generator, init_image_generator
    from repro_torch.utils.prng import Draws
    from repro_torch.utils.trees import flatten_dict, value_and_grad

    dev = torch.device("cuda")
    classes, shape, k, batch, latent = 4, (16, 16, 3), 3, 16, 8
    g = torch.Generator(device=dev).manual_seed(0)
    clients = [init_cnn(g, "cnn5", classes, shape) for _ in range(k)]
    server = init_cnn(g, "cnn5", classes, shape)
    gen0 = init_image_generator(g, latent, classes, shape)
    w = torch.softmax(torch.randn((k,), generator=g, device=dev), 0)
    logits_all = make_logits_all([partial(cnn_apply, "cnn5")] * k)
    server_apply = partial(cnn_apply, "cnn5")
    gen_apply = lambda p, z, y: image_generator(p, z, y, shape)
    draws = Draws(1, dev)
    z, y = draws.zy(batch, latent, classes)
    with torch.no_grad():
        x = gen_apply(gen0, z, y)
    xd = diversify(logits_all, clients, w, x, draws.direction((batch, classes)), 8.0 / 255.0)
    with torch.no_grad():
        la = logits_all(clients, xd)

    def gen_loss(gp, backend):
        xg = gen_apply(gp, z, y)
        return generator_loss(logits_all(clients, xg), w, server_apply(server, xg), y, backend=backend)

    got = {}
    for backend in ("cuda", "ref"):
        lg, g_gen = value_and_grad(gen_loss, gen0, backend)
        lk, g_srv = value_and_grad(make_kd_loss(logits_all, server_apply, 4.0, backend), server, xd, clients, w)
        got[backend] = {"gen_loss": lg, "kd_loss": lk, "g_w": weight_grad(w, la, y, backend)}
        got[backend].update({f"g_gen {p}": v for p, v in flatten_dict(g_gen).items()})
        got[backend].update({f"g_srv {p}": v for p, v in flatten_dict(g_srv).items()})
    worst = max(_err(f"small input {name}", got["cuda"][name], want) for name, want in got["ref"].items())
    print(f"small input: kernel gradients vs plain autograd, largest abs err {worst:.3e}", flush=True)

    cfg = OFLConfig(num_clients=k, gen_iters=3, batch_size=batch, latent_dim=latent, buffer_batches=2)
    runs = []
    for backend in ("cuda", "ref", "ref"):
        c = dataclasses.replace(cfg, backend=backend)
        step, gen_opt, srv_opt = make_coboost_epoch(logits_all, server_apply, gen_apply, c, k, classes)
        buf = buffer_init(c.buffer_batches, (batch, *shape), device=dev)
        order, n_valid = distill_schedule(0, c.buffer_batches)
        sp, _, gp, _, w1, buf, _, gloss, dmean = step(
            server, srv_opt.init(server), gen0, gen_opt.init(gen0), torch.full((k,), 1.0 / k, device=dev),
            buf, Draws(2, dev), 0, order, n_valid, clients,
        )
        if not (math.isfinite(float(gloss)) and math.isfinite(float(dmean))):
            fail(f"small epoch ({backend}): non-finite loss")
        runs.append((flatten_dict(sp), flatten_dict(gp), w1, buf.x[0].clone()))

    def gaps(a, b):
        diff = lambda d1, d2: max(float((d1[p] - d2[p]).abs().max()) for p in d2 if torch.is_tensor(d2[p]))
        return {
            "server": diff(a[0], b[0]), "generator": diff(a[1], b[1]),
            "w": float((a[2] - b[2]).abs().max()), "buffer": float((a[3] - b[3]).abs().max()),
        }

    print("small epoch gaps, cuda vs ref: " + json.dumps(gaps(runs[0], runs[1])), flush=True)
    print("small epoch gaps, ref vs ref:  " + json.dumps(gaps(runs[2], runs[1])), flush=True)
    small_baselines_agreement(clients, server, gen0, server_apply, gen_apply, cfg, classes, shape)


def small_baselines_agreement(clients, server, gen0, cnn5_apply, gen_apply, cfg, classes, shape):
    """One epoch of each distilling baseline at phase 3's small size, with
    the kernels (backend "cuda") and with plain autograd (backend "ref")
    from the same parameters and draws: the largest server-parameter gap is
    printed and must be finite, beside the gap between two plain runs (the
    convolutions' own run-to-run spread, which Adam's first steps amplify in
    the synthesis phase; ``tests/test_torch_cuda.py`` holds cuDNN to its
    deterministic algorithms and bounds the kernels' gap). Clients and
    server are cnn5, applied by ``cnn5_apply``."""
    import dataclasses

    import torch

    from repro_torch.core.baselines import run_adi_baseline, run_feddf, run_generator_baseline
    from repro_torch.utils.prng import Draws
    from repro_torch.utils.trees import flatten_dict

    dev = torch.device("cuda")
    applies = [cnn5_apply] * len(clients)
    g = torch.Generator(device=dev).manual_seed(4)
    val_x = torch.rand((3 * cfg.batch_size, *shape), generator=g, device=dev) * 2 - 1
    gaps, spread = {}, {}
    for method in DISTILLING:
        servers = []
        for backend in ("cuda", "ref", "ref"):
            c = dataclasses.replace(cfg, backend=backend, epochs=1)
            draws = Draws(3, dev)
            if method == "f_adi":
                st = run_adi_baseline(applies, clients, cnn5_apply, server, shape, c, classes, draws)
            elif method == "feddf":
                st = run_feddf(applies, clients, cnn5_apply, server, val_x, c, draws)
            else:
                st = run_generator_baseline(method, applies, clients, cnn5_apply, server, gen_apply, gen0, c,
                                            classes, draws)
            servers.append(flatten_dict(st.server_params))
        gap = lambda a, b: max(float((a[p] - b[p]).abs().max()) for p in b if torch.is_tensor(b[p]))
        gaps[method], spread[method] = gap(servers[0], servers[1]), gap(servers[2], servers[1])
        if not math.isfinite(gaps[method]):
            fail(f"small {method} epoch: non-finite server parameters")
    print("small baseline epochs, server-parameter gaps, cuda vs ref: " + json.dumps(gaps), flush=True)
    print("small baseline epochs, server-parameter gaps, ref vs ref:  " + json.dumps(spread), flush=True)


def _lm_grads(cfg, params, batch):
    """``lm_loss`` and its gradients (flattened) through the kernels
    (backend "cuda") and through plain autograd (backend "ref")."""
    out = {}
    for backend in ("cuda", "ref"):
        loss, flat = _loss_and_grads(cfg.replace(backend=backend), params, batch)
        out[backend] = {"loss": loss, **flat}
    return out["cuda"], out["ref"]


def lm_small_input_agreement():
    """Reduced smollm-135m in f32: the gradients of one ``lm_loss`` through
    the attention kernels agree with plain autograd."""
    import torch

    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(3))
    batch = {n: torch.as_tensor(a, device=dev) for n, a in make_token_stream(3, cfg.vocab_size, 4, 64).items()}
    reset_launch_counts()
    got, want = _lm_grads(cfg, params, batch)
    _check_variants("reduced lm_loss", launch_counts(), "float32")
    worst = max(_err(f"reduced lm_loss {name}", got[name], w) for name, w in want.items())
    print(f"small input: reduced smollm-135m lm_loss gradients, kernels vs plain autograd, largest abs err {worst:.3e}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 4


def main_path():
    import time

    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import ofl

    reset_launch_counts()
    t0 = time.perf_counter()
    result = ofl.main(["--method", "coboosting", *OFL_ARGV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: launch_counts()[n] for n in LOSS_KERNELS}
    print(f"training path ({wall:.1f} s): {json.dumps(result)}", flush=True)
    for name, n in counts.items():
        if n == 0:
            fail(f"training path never launched {name}")
    for key in ("server_acc", "ensemble_acc", "gen_loss", "distill_loss"):
        if key not in result or not math.isfinite(result[key]):
            fail(f"main path result lacks a finite {key}: {result}")
    return counts, result


# ---------------------------------------------------------------------------
# phase 4b


def _expected_kl_launches(method, run):
    """One ``ensemble_kl`` forward and one backward per distillation step:
    one step per filled ring slot for the synthetic-data methods, one per
    whole batch of the training images for FedDF, none without training."""
    cfg = run.cfg
    if method == "feddf":
        return (len(run.train_x) // cfg.batch_size) * cfg.epochs
    if method in DISTILLING:
        return sum(min(e + 1, cfg.buffer_batches) for e in range(cfg.epochs))
    return 0


def _timed_eval_fn(evals):
    """A stand-in for ``market.market_eval_fn`` whose evaluations append
    ``(start, end, server finite)`` to ``evals``, each after a synchronize:
    with evaluation after every epoch, the time between them is the
    epochs' own."""
    import torch

    from repro_torch.fed import market
    from repro_torch.utils.trees import tree_leaves

    def make(*a, **kw):
        fn = market.market_eval_fn(*a, **kw)

        def timed(server_params, w):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(server_params, w)
            finite = server_params is None or all(bool(torch.isfinite(t).all()) for t in tree_leaves(server_params))
            evals.append((start, time.perf_counter(), finite))
            return out

        return timed

    return make


def _per_epoch(evals):
    """Seconds an epoch after the first: the span between the first
    evaluation's end and the last one's start, evaluations taken out."""
    if len(evals) < 2:
        return None
    between = evals[-1][0] - evals[0][1] - sum(e - s for s, e, _ in evals[1:-1])
    return between / (len(evals) - 1)


def baselines_path(coboost):
    """The paper's Table 1 baselines through ``run_method`` on one market,
    built once with phase 4's settings; each method's launches counted from
    0, its wall time and its seconds per epoch after the first (evaluation
    after every epoch, its time taken out), its accuracies and losses. Then
    Co-Boosting on the same market, and phase 4's numbers beside them."""
    import time

    import torch

    from repro_torch.fed import market
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import ofl
    from repro_torch.utils.device import disable_tf32

    dev = torch.device("cuda")
    disable_tf32()
    args = ofl.parse_args(OFL_ARGV)
    t0 = time.perf_counter()
    run = ofl.prepare_run(args, dev)
    torch.cuda.synchronize()
    print(f"baselines: market of {args.clients} {run.archs or 'cnn5'} clients on {len(run.train_x)} images "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    # the runners evaluate through ofl.market_eval_fn: wrap it to stamp each
    # evaluation (after a synchronize) and to check the server it is handed
    evals = []
    ofl.market_eval_fn = _timed_eval_fn(evals)
    table = {}
    try:
        for method in DISTILLING + ("fedavg", "fedens", "coboosting"):
            evals.clear()
            reset_launch_counts()
            t0 = time.perf_counter()
            result = ofl.run_method(
                method, run.cfg, args.classes, run.image_shape, run.applies, run.params, run.sizes,
                run.train_x, run.test_x, run.test_y, args.server_arch, args.seed, eval_every=1, device=dev,
                archs=run.archs,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {n: launch_counts()[n] for n in LOSS_KERNELS}
            row = {"wall_s": wall, "s_per_epoch_after_first": _per_epoch(evals), "launches": counts,
                   **{k: v for k, v in result.items() if isinstance(v, (int, float))}}
            table[method] = row
            print(f"baseline {method}: {json.dumps(row)}", flush=True)
            if not evals or not all(f for _, _, f in evals):
                fail(f"{method}: a server parameter is not finite (or nothing was evaluated)")
            if method == "coboosting":
                if min(counts.values()) == 0:
                    fail(f"coboosting on the baselines' market never launched a loss kernel: {counts}")
            else:
                kl = _expected_kl_launches(method, run)
                want = {"ensemble_kl_fwd": kl, "ensemble_kl_bwd": kl, "ghm_ce_fwd": 0, "ghm_ce_bwd": 0}
                if counts != want:
                    fail(f"{method}: loss-kernel launches {counts}, want {want} (one ensemble_kl pair a step)")
            if "ensemble_acc" not in result:
                fail(f"{method}: no ensemble_acc in {result}")
            if method == "fedens":
                if "server_acc" in result:
                    fail(f"fedens trains no server but reported server_acc: {result}")
            elif "server_acc" not in result:
                fail(f"{method}: no server_acc in {result}")
            if method in ("dense", "f_dafl", "coboosting"):
                for key in ("gen_loss", "distill_loss"):
                    if key not in result or not math.isfinite(result[key]):
                        fail(f"{method}: result lacks a finite {key}: {result}")
    finally:
        ofl.market_eval_fn = market.market_eval_fn
    print("Table 1 on one market (server_acc, ensemble_acc): " + json.dumps(
        {m: [r.get("server_acc"), r["ensemble_acc"]] for m, r in table.items()}), flush=True)
    print(f"Co-Boosting, phase 4 (same settings and seed): server_acc {coboost['server_acc']}, "
          f"ensemble_acc {coboost['ensemble_acc']}", flush=True)


# ---------------------------------------------------------------------------
# phase 4c


def _stack_and_input_grad(fn, params, x, u):
    """The (K, B, C) stack and the gradient of ``sum(u * stack)`` with
    respect to the images, as DHS and the generator take it."""
    import torch

    xi = x.detach().requires_grad_()
    la = fn(params, xi)
    (g,) = torch.autograd.grad(torch.sum(la * u), xi)
    return la.detach(), g


def _rel(got, want, norm=float("inf")):
    """``‖got − want‖ / ‖want‖`` in float64, in the max norm or another."""
    import torch

    norm_of = lambda t: torch.linalg.vector_norm(t.double().flatten(), norm)
    return float(norm_of(got.double() - want.double()) / norm_of(want))


def hetero_bank_check():
    """Table 3's market at the paper's image width, whole and family by
    family: each engine's stack and input gradient, in f32 and in float64;
    each engine's f32 time for the stack and its gradient (CUDA events)."""
    from functools import partial

    import torch

    from repro_torch.core.client_bank import ClientBank, make_ensemble
    from repro_torch.models.cnn import cnn_apply, init_cnn
    from repro_torch.utils.device import disable_tf32
    from repro_torch.utils.trees import tree_map

    dev = torch.device("cuda")
    disable_tf32()
    k, b, classes, shape = 10, 128, 10, (32, 32, 3)
    archs = [HETERO_ARCHS[i % len(HETERO_ARCHS)] for i in range(k)]
    g = torch.Generator(device=dev).manual_seed(0)
    applies = [partial(cnn_apply, a) for a in archs]
    params = {"f32": [init_cnn(g, a, classes, shape) for a in archs]}
    params["f64"] = [tree_map(torch.Tensor.double, p) for p in params["f32"]]
    x = torch.rand((b, *shape), generator=g, device=dev) * 2 - 1
    xs = {"f32": x, "f64": x.double()}
    u = torch.rand((k, b, classes), generator=g, device=dev) * 2 - 1
    engines = {"looped": dict(impl="looped"), "grouped": {}, f"grouped, chunks of {BANK_CHUNK}": dict(scan_chunk=BANK_CHUNK)}
    grouped = [n for n in engines if n != "looped"]
    gaps = {}
    for fam in ("market",) + HETERO_ARCHS:
        sel = [i for i, a in enumerate(archs) if fam in ("market", a)]
        got = {
            (name, prec): _stack_and_input_grad(
                *make_ensemble([applies[i] for i in sel], [params[prec][i] for i in sel], **kw), xs[prec], u[sel]
            )
            for name, kw in engines.items() for prec in ("f32", "f64")
        }
        for key, (la, gx) in got.items():
            if not (torch.isfinite(la).all() and torch.isfinite(gx).all()):
                fail(f"client bank ({fam}, {key}): the stack or its input gradient is not finite")
        exact = got["looped", "f64"]
        gaps[fam] = {
            "stack_f32": {n: _rel(got[n, "f32"][0], got["looped", "f32"][0]) for n in grouped},
            "grad_f64": {n: _rel(got[n, "f64"][1], exact[1]) for n in grouped},
            "grad_f32_to_f64_max": {n: _rel(got[n, "f32"][1], exact[1]) for n in engines},
            "grad_f32_to_f64_l2": {n: _rel(got[n, "f32"][1], exact[1], 2) for n in engines},
        }
    ms = {}
    for name, kw in engines.items():
        fn, p = make_ensemble(applies, params["f32"], **kw)
        for _ in range(3):
            _stack_and_input_grad(fn, p, x, u)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            _stack_and_input_grad(fn, p, x, u)
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / 10
    bank, _ = ClientBank.build(applies, params["f32"])
    print(f"client bank, Table 3 market (K={k}: {','.join(archs)}; 32x32x3, {classes} classes, batch {b}; "
          f"{bank.num_groups} groups {list(bank.counts)}), whole market and by family, gaps relative to the "
          f"largest value: the f32 stack to looped's (limit {BANK_TOL}), the float64 input gradient to the "
          f"float64 loop's (limit {BANK_TOL_F64}), and each engine's f32 input gradient to the float64 loop's, "
          f"in the max and the L2 norm (not gated: ReLU and max-pool make it jump at rounding level) "
          f"{json.dumps(gaps)}; f32 ms for the stack and its input gradient (CUDA events, 10 calls) "
          f"{json.dumps(ms)}", flush=True)
    for fam, gap in gaps.items():
        for name in grouped:
            if gap["stack_f32"][name] > BANK_TOL or gap["grad_f64"][name] > BANK_TOL_F64:
                fail(f"client bank ({fam}, {name}): f32 stack gap {gap['stack_f32'][name]:.3g} (limit {BANK_TOL}), "
                     f"float64 input gradient gap {gap['grad_f64'][name]:.3g} (limit {BANK_TOL_F64})")


def _coboost_by_engine(label, runs, args, want_counts, tmp):
    """Co-Boosting through ``launch.ofl.run_method`` with each engine in
    BANK_TURNS' turns (``runs[impl]`` is the market it runs on; evaluation
    after every epoch, for s/epoch after the first), then once more each
    under ``torch.profiler`` for the device ms and launches an epoch inside
    ``ofl.epoch`` (``repro_torch.obs.phases``), its largest kernels and the
    peak device memory. The loss kernels must launch ``want_counts`` in
    every run."""
    import dataclasses

    import torch

    from repro_torch import obs
    from repro_torch.fed import market
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import ofl
    from repro_torch.obs.phases import device_split

    dev = torch.device("cuda")
    evals = []
    per_epoch = {"looped": [], "grouped": []}
    device = {}
    ofl.market_eval_fn = _timed_eval_fn(evals)
    try:
        for turn, impl in enumerate(BANK_TURNS + ("looped", "grouped")):
            profile = turn >= len(BANK_TURNS)
            run = runs[impl]
            cfg = dataclasses.replace(run.cfg, ensemble_impl=impl)
            evals.clear()
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            if profile:
                obs.configure(profile_dir=f"{tmp}/{label}_{impl}", device=dev)
            result = ofl.run_method(
                "coboosting", cfg, args.classes, run.image_shape, run.applies, run.params, run.sizes,
                run.train_x, run.test_x, run.test_y, args.server_arch, args.seed, eval_every=1, device=dev,
                archs=run.archs,
            )
            torch.cuda.synchronize()
            counts = {n: launch_counts()[n] for n in LOSS_KERNELS}
            if counts != want_counts:
                fail(f"client bank, {label} {impl}: loss-kernel launches {counts} != {want_counts}")
            for key in ("server_acc", "ensemble_acc", "gen_loss", "distill_loss"):
                if key not in result or not math.isfinite(result[key]):
                    fail(f"client bank, {label} {impl}: result lacks a finite {key}: {result}")
            if not all(f for _, _, f in evals):
                fail(f"client bank, {label} {impl}: a server parameter is not finite")
            if not profile:
                per_epoch[impl].append(_per_epoch(evals))
                continue
            split = device_split(obs.stop_torch_profile(obs.tracer()), top=8)
            obs.configure()
            outer, epochs = split["outer"], split["outer"]["count"]
            device[impl] = {
                "device_ms_per_epoch": outer["device_ms"] / epochs,
                "launches_per_epoch": outer["launches"] / epochs,
                "peak_mb": torch.cuda.max_memory_allocated() / 2**20,
                "server_acc": result["server_acc"], "ensemble_acc": result["ensemble_acc"],
                "largest_kernels_ms_and_launches_per_epoch": [[name[:64], ms / epochs, n / epochs]
                                                               for name, ms, n in outer["top"]],
            }
    finally:
        ofl.market_eval_fn = market.market_eval_fn
    print(f"client bank, Co-Boosting {label}: s/epoch after the first, turns {','.join(BANK_TURNS)}: "
          f"{json.dumps(per_epoch)}; profiled: {json.dumps(device)}; loss-kernel launches {json.dumps(want_counts)} "
          f"in every run", flush=True)


def bank_path(coboost_counts):
    """Phase 4c: Table 3's market, then Co-Boosting by engine at K=5 and at
    K=20 cnn5 (both markets' build seconds: per client, and grouped)."""
    import torch

    from repro_torch.launch import ofl
    from repro_torch.utils.device import disable_tf32

    t0 = time.perf_counter()
    hetero_bank_check()
    dev = torch.device("cuda")
    disable_tf32()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bank_") as tmp:
        args = ofl.parse_args(OFL_ARGV)
        run = ofl.prepare_run(args, dev)
        _coboost_by_engine("K=5", {"looped": run, "grouped": run}, args, coboost_counts, tmp)
        runs, build_s = {}, {}
        for impl, flags in (("looped", []), ("grouped", ["--grouped-market"])):
            args = ofl.parse_args([*OFL_ARGV, "--clients", "20", *flags])  # the last --clients counts
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            runs[impl] = ofl.prepare_run(args, dev)
            torch.cuda.synchronize()
            build_s[impl] = time.perf_counter() - t1
        print(f"client bank, K=20 cnn5 market ({len(runs['looped'].train_x)} images, {args.local_epochs} local "
              f"epochs) built in seconds: per client {build_s['looped']:.3f}, grouped (--grouped-market) "
              f"{build_s['grouped']:.3f}", flush=True)
        _coboost_by_engine("K=20 cnn5", runs, args, coboost_counts, tmp)
    print(f"client bank phase: {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 5


def _engine_vs_static(where, cfg, params, n, gen, prompt, seed=1, gated=False, attention=True):
    """The paged engine's greedy tokens against the static dense-cache
    path's (``static_generate``; the same prefill kernel, decode
    through the plain small-SDPA) for ``n`` requests x ``gen`` tokens, in
    f32 on the CUDA-core kernels. The static path's smallest teacher-forced
    top-2 margin must exceed 1e-3, so that no near-tie decides a token;
    ``gated``: each request's tokens are compared before its first
    near-tie instead (as phase 5c does), and at least half of all positions
    must be compared. ``attention=False``: an arch without attention (its
    launches are checked by the caller). Returns the smallest margin
    compared, the count of positions compared, the engine's launches and
    its stats."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine, static_generate

    dev = torch.device("cuda")
    tokens = make_token_stream(seed, cfg.vocab_size, n, prompt)["tokens"]
    ecfg = EngineConfig(max_slots=n, max_seq=prompt + gen, max_new=gen, page_size=SERVE["page"], kv_layout="paged")
    eng = ServeEngine(cfg, params, ecfg)
    reset_launch_counts()
    comps = ContinuousScheduler(eng, clock=ManualClock()).run(
        [Request(rid=i, tokens=tokens[i], max_new_tokens=gen) for i in range(n)]
    )
    counts = launch_counts()
    prompts = torch.as_tensor(tokens, device=dev)
    want = static_generate(params, cfg, {"tokens": prompts}, gen)
    if attention:
        _check_variants(where, launch_counts(), "float32")
    with torch.inference_mode():  # the logits behind each static token, teacher-forced
        logits, _ = lm_forward(params, cfg, {"tokens": torch.cat([prompts, want[:, :-1].to(prompts.dtype)], 1)})
    top2 = logits[:, prompt - 1 :].topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    del logits
    # per request, the positions before its first near-tie (all of them when not gated)
    gates = [int(np.flatnonzero(m <= NEAR_TIE)[0]) if (m <= NEAR_TIE).any() else gen for m in margins]
    if not gated and min(gates) < gen:
        fail(f"{where}: the static path has a near-tie (top-2 margin {margins.min():.2e}), the comparison cannot decide")
    if sum(gates) < n * gen / 2:
        fail(f"{where}: near-ties leave {sum(gates)} of {n * gen} positions to compare (gates {gates})")
    margin = float(min(m[:g].min() for m, g in zip(margins, gates) if g))
    want = want.cpu().numpy()
    got = np.stack([c.tokens for c in comps])
    if not all(np.array_equal(a[:g], b[:g]) for a, b, g in zip(got, want, gates)):
        fail(f"{where}: paged engine tokens {got.tolist()} != static dense-cache path {want.tolist()} "
             f"(compared before positions {gates})")
    return margin, sum(gates), counts, dict(eng.stats)


def serving_parity_f32():
    """Full width in f32: the paged engine's greedy tokens equal the static
    dense-cache path's for 4 requests x 16 tokens. As in the CPU serving
    test, the tied embedding is scaled by 10 to widen the random model's
    top-2 logit margins."""
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    cfg = get_arch("smollm-135m").replace(dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    params["embed"]["table"] *= 10.0
    n, gen = 4, 16
    margin, _, _, _ = _engine_vs_static("f32 serving", cfg, params, n, gen, SERVE["prompt"])
    print(f"serving f32 at full width: paged engine == static dense-cache path (same prefill kernel) on {n}x{gen} "
          f"tokens, smallest top-2 margin {margin:.3e}", flush=True)


def serving_path():
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    reset_launch_counts()
    t0 = time.perf_counter()
    result = serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: launch_counts()[n] for n in ATTN_KERNELS}
    _check_variants("serving path", launch_counts(), "bfloat16")
    comps = result["completions"]
    summary = {k: result[k] for k in ("tok_per_s", "tokens", "p50_s", "p95_s", "ttft_p50_s", "ttft_p95_s", "wall_s")}
    print(f"serving path ({wall:.1f} s with set-up): {json.dumps(summary)}", flush=True)
    for name, n in counts.items():
        if n == 0:
            fail(f"serving path never launched {name}")
    if len(comps) != SERVE["requests"] or any(len(c.tokens) != SERVE["gen"] for c in comps):
        fail(f"serving path: expected {SERVE['requests']} completions of {SERVE['gen']} tokens")
    if any(int(t) < 0 or int(t) >= 49152 for c in comps for t in c.tokens):
        fail("serving path: token id out of the vocabulary")
    # the same run again under torch.profiler (device activity only): the
    # device's busy and idle share; its times are not the ones above
    prof = serve.main(SERVE_ARGV + ["--profile"])
    busy, pwall = prof["device_busy_s"], prof["wall_s"]
    print(f"serving path profiled: device busy {busy:.3f} s of {pwall:.3f} s wall, idle share {1 - busy / pwall:.3f}", flush=True)
    return counts, result["stats"]


# ---------------------------------------------------------------------------
# phase 5c


def _launch_rule(where, counts, stats, drafter_prefills, spec, dtype, layers=None):
    """#5 once a layer for every prefill of the target and of the drafter
    (a spliced admission's tail runs through ``lm_extend``, not #5); #8 in
    a plain decode chunk and never in a speculative one."""
    _check_variants(where, counts, dtype)
    layers = layers or TRAIN["layers"]
    want = layers * (stats["prefill_dispatches"] + drafter_prefills)
    if counts["flash_attention_fwd"] != want:
        fail(f"{where}: flash_attention_fwd launched {counts['flash_attention_fwd']} times, expected {want} "
             f"({layers} x ({stats['prefill_dispatches']} target + {drafter_prefills} drafter prefills))")
    if spec and counts["flash_decode"]:
        fail(f"{where}: flash_decode launched {counts['flash_decode']} times in a speculative run")
    if not spec and not counts["flash_decode"]:
        fail(f"{where}: flash_decode never launched")


def _cold_gates(params, cfg, reqs, cold, where="prefix/spec f32"):
    """Per request, the positions before its first near-tie: the cold
    path's teacher-forced top-2 margins (``lm_forward`` over the prompt and
    its tokens); the cold tokens must be those argmaxes there."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import lm_forward

    gates, smallest = {}, float("inf")
    with torch.inference_mode():
        for r in reqs:
            toks = cold[r.rid]
            seq = torch.as_tensor(np.concatenate([r.tokens, toks[:-1]]), device="cuda")[None]
            rows = lm_forward(params, cfg, {"tokens": seq})[0][0, len(r.tokens) - 1 :]
            top2 = rows.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            smallest = min(smallest, float(margin.min()))
            near = np.flatnonzero(margin <= NEAR_TIE)
            gates[r.rid] = int(near[0]) if len(near) else len(toks)
            if not np.array_equal(rows.argmax(-1).cpu().numpy()[: gates[r.rid]], toks[: gates[r.rid]]):
                fail(f"{where}: rid {r.rid}: cold tokens are not the teacher-forced argmaxes")
    return gates, smallest


def prefix_spec_f32():
    """Four engines on one hot-prefix stream at full width in f32."""
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine, hot_prefix_stream

    dev = torch.device("cuda")
    cfg = get_arch("smollm-135m").replace(dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    params["embed"]["table"] *= 10.0
    other = init_lm(cfg, torch.Generator(device=dev).manual_seed(2))  # the seed + 1 drafter
    prompts, _ = hot_prefix_stream(cfg.vocab_size, HOT["requests"], HOT["prompt"], HOT["gen"], seed=1,
                                   budget_min=1, shared_fraction=HOT["shared"])
    reqs = [Request(rid=i, tokens=p, max_new_tokens=HOT["gen"], arrival=2.0 * i) for i, p in enumerate(prompts)]
    base = dict(max_slots=HOT["slots"], max_seq=HOT["prompt"] + HOT["gen"], max_new=HOT["gen"],
                page_size=HOT["page"])
    arms = {
        "cold": ({}, None),
        "prefix": (dict(prefix_cache=True), None),
        "prefix+spec matched": (dict(prefix_cache=True, spec_k=HOT["spec_k"]), (cfg, params)),
        "spec seed+1 drafter": (dict(spec_k=HOT["spec_k"]), (cfg, other)),
    }
    out, stats = {}, {}
    for name, (knobs, drafter) in arms.items():
        eng = ServeEngine(cfg, params, EngineConfig(**base, **knobs), drafter=drafter)
        sched = ContinuousScheduler(eng, clock=ManualClock(tick=0.2))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        comps = sched.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: launch_counts()[n] for n in ATTN_KERNELS}
        st = dict(eng.stats)
        dp = eng.spec.prefill_dispatches if eng.spec is not None else 0
        _launch_rule(f"prefix/spec f32 {name}", launch_counts(), st, dp, "spec_k" in knobs, "float32")
        out[name], stats[name] = {c.rid: c.tokens for c in comps}, st
        acc = st["draft_accepted"] / st["draft_proposed"] if st["draft_proposed"] else None
        print(f"prefix/spec f32 {name}: {wall:.2f} s; stats {json.dumps(st)}; drafter prefills {dp}; acceptance "
              f"{acc}; launches {json.dumps(counts)}", flush=True)
    gates, smallest = _cold_gates(params, cfg, reqs, out["cold"])
    gated = sum(gates.values())
    for name in arms:
        for rid, g in gates.items():
            if not np.array_equal(out[name][rid][:g], out["cold"][rid][:g]):
                fail(f"prefix/spec f32 {name}: rid {rid} tokens {out[name][rid].tolist()} != cold "
                     f"{out['cold'][rid].tolist()} before its first near-tie (position {g})")
    for name in ("prefix", "prefix+spec matched"):
        st = stats[name]
        if st["spliced_admissions"] <= 0 or st["prefill_tokens"] >= stats["cold"]["prefill_tokens"]:
            fail(f"prefix/spec f32 {name}: spliced {st['spliced_admissions']}, prefill tokens "
                 f"{st['prefill_tokens']} (cold {stats['cold']['prefill_tokens']})")
    st = stats["prefix+spec matched"]
    if st["draft_accepted"] <= 0.5 * st["draft_proposed"]:
        fail(f"prefix/spec f32: the matched drafter's acceptance {st['draft_accepted']}/{st['draft_proposed']} <= 0.5")
    print(f"prefix/spec f32 at full width: tokens of all four engines equal on {gated} of "
          f"{HOT['requests'] * HOT['gen']} positions (those before each request's first near-tie), smallest "
          f"cold top-2 margin {smallest:.3e}", flush=True)


def _splice_gap():
    """bf16 against f32: the spliced tail's last-position logits (head
    pages from a cold prefill of the first hot prompt, tail through
    ``lm_extend``) and a cold prefill's, both against the f32 cold
    prefill, over the other hot prompts of the launcher's stream. Returns
    the largest gap of each relative to the largest |f32 logit|, and the
    f32 splice's own gap."""
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import cast_weights, init_lm, init_lm_state, lm_extend, lm_prefill
    from repro_torch.serve import hot_prefix_stream

    dev = torch.device("cuda")
    ps, n = SERVE["page"], SERVE["prompt"] + SERVE["gen"]
    f32 = get_arch("smollm-135m").replace(dtype="float32")
    params = init_lm(f32, torch.Generator(device=dev).manual_seed(0))  # the launcher's weights (--seed 0)
    prompts, _ = hot_prefix_stream(f32.vocab_size, SERVE["requests"], SERVE["prompt"], SERVE["gen"], seed=0,
                                   budget_min=1, shared_fraction=0.5)
    head = SERVE["prompt"] // 2 // ps  # full pages of the shared head
    hot = [p for p in prompts if np.array_equal(p[: head * ps], prompts[0][: head * ps])]

    def cold(cfg, w, p):
        st = init_lm_state(cfg, 1, n, device=dev)
        return lm_prefill(w, cfg, {"tokens": torch.as_tensor(p[None], device=dev)}, st)[0][0, 0].float()

    def spliced(cfg, w, src, p):
        st = init_lm_state(cfg, 1, n, device=dev)
        lm_prefill(w, cfg, {"tokens": torch.as_tensor(src[None], device=dev)}, st)
        pages = init_lm_state(cfg, 1, n, kv_pages=n // ps + 1, kv_page_size=ps, device=dev)
        for dense, paged in (("k", "k_pages"), ("v", "v_pages")):
            pages[paged][:, :head] = st[dense][:, 0, : head * ps].unflatten(1, (head, ps))
        table = torch.full((1, n // ps), n // ps, dtype=torch.int32, device=dev)
        table[0, :head] = torch.arange(head, dtype=torch.int32, device=dev)
        table[0, head:] = torch.arange(head, n // ps, dtype=torch.int32, device=dev)
        tail = torch.as_tensor(p[None, head * ps :], device=dev)
        start = torch.full((1,), head * ps, dtype=torch.int32, device=dev)
        return lm_extend(w, cfg, tail, pages, start, table)[0][0, -1].float()

    gaps = {"cold": 0.0, "spliced": 0.0, "spliced_f32": 0.0}
    with torch.inference_mode():
        bf16 = f32.replace(dtype="bfloat16")
        wb = cast_weights(params, bf16)
        for p in hot[1:]:
            ref = cold(f32, params, p)
            scale = float(ref.abs().max())
            gaps["cold"] = max(gaps["cold"], float((cold(bf16, wb, p) - ref).abs().max()) / scale)
            gaps["spliced"] = max(gaps["spliced"], float((spliced(bf16, wb, hot[0], p) - ref).abs().max()) / scale)
            gaps["spliced_f32"] = max(gaps["spliced_f32"],
                                      float((spliced(f32, params, hot[0], p) - ref).abs().max()) / scale)
    return gaps, len(hot) - 1


def prefix_spec_path():
    """bf16 through ``launch.serve`` on hot-prefix traffic: plain, prefix
    cache, prefix cache with speculative decoding."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve

    results = {}
    undo = _counted_runs()  # the counts cover the timed run, not the warm-up
    try:
        for flags in HOT_FLAGS:
            name = " ".join(flags[2:]) or "plain"
            result = serve.main(SERVE_ARGV + flags)
            torch.cuda.synchronize()
            counts = launch_counts()
            st = result["stats"]
            _launch_rule(f"hot-prefix serving {name}", counts, st, result["drafter_prefills"],
                         "--spec-decode" in flags, "bfloat16")
            comps = result["completions"]
            if len(comps) != SERVE["requests"] or any(len(c.tokens) != SERVE["gen"] for c in comps):
                fail(f"hot-prefix serving {name}: expected {SERVE['requests']} completions of {SERVE['gen']} tokens")
            results[name] = result
            toks = {c.rid: c.tokens for c in comps}
            plain = {c.rid: c.tokens for c in results["plain"]["completions"]}
            same = sum(int((toks[r] == plain[r]).sum()) for r in toks) / (SERVE["requests"] * SERVE["gen"])
            acc = st["draft_accepted"] / st["draft_proposed"] if st["draft_proposed"] else None
            summary = {k: result[k] for k in ("tok_per_s", "p50_s", "p95_s", "ttft_p50_s", "ttft_p95_s", "wall_s")}
            print(f"hot-prefix serving {name}: {json.dumps(summary)}; prefill tokens {st['prefill_tokens']}, "
                  f"spliced {st['spliced_admissions']}/{st['admitted']}, CoW copies {st['cow_copies']}, "
                  f"acceptance {acc} ({st['draft_accepted']}/{st['draft_proposed']}, {st['spec_steps']} verify "
                  f"steps), drafter prefills {result['drafter_prefills']}; share of tokens equal to the plain run "
                  f"{same:.4f}; launches {json.dumps({n: counts[n] for n in ATTN_KERNELS})}", flush=True)
    finally:
        undo()
    gaps, n = _splice_gap()
    print(f"hot-prefix serving, bf16 vs f32 cold prefill at the last prompt position over {n} hot prompts (largest "
          f"|gap| / largest |f32 logit|): cold bf16 {gaps['cold']:.3e}, spliced bf16 {gaps['spliced']:.3e} (limit "
          f"2 x {gaps['cold']:.3e}), spliced f32 {gaps['spliced_f32']:.3e}", flush=True)
    if gaps["spliced"] > 2 * gaps["cold"]:
        fail(f"hot-prefix serving: the spliced bf16 logits' gap {gaps['spliced']:.3e} beyond 2 x {gaps['cold']:.3e}")


# ---------------------------------------------------------------------------
# phase 5d


def _counted_runs():
    """Patch ``FleetRouter.run`` (and so ``ContinuousScheduler.run``) to
    reset the launch counters when a run starts: the counts then cover the
    launcher's timed run, not its warm-up. Returns the undo."""
    import torch

    from repro_torch.kernels import reset_launch_counts
    from repro_torch.serve.scheduler import FleetRouter

    run = FleetRouter.run

    def counted_run(self, requests):
        torch.cuda.synchronize()
        reset_launch_counts()
        return run(self, requests)

    FleetRouter.run = counted_run
    return lambda: setattr(FleetRouter, "run", run)


def fleet_f32():
    """smollm-135m at full width in f32 on a staggered stream: one engine,
    two replicas with replica 0 a cross-device pair (prefill on the CPU,
    decode on the card), three colocated replicas, each on
    ``ManualClock``."""
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import ContinuousScheduler, EngineConfig, FleetRouter, ManualClock, ServeEngine, staggered_stream

    dev = torch.device("cuda")
    cfg = get_arch("smollm-135m").replace(dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    params["embed"]["table"] *= 10.0
    reqs = staggered_stream(cfg.vocab_size, FLEET["requests"], seed=1, prompt_range=FLEET["prompt"],
                            budget_range=FLEET["budget"])
    ecfg = dict(max_slots=FLEET["slots"], max_seq=FLEET["max_seq"], max_new=FLEET["budget"][1], page_size=SERVE["page"])
    out = {}
    for name, placement in FLEET["arms"].items():
        engines = [ServeEngine(cfg, params, EngineConfig(**ecfg), prefill_device=d, replica=i)
                   for i, d in enumerate(placement)]
        clock = ManualClock(tick=0.2)
        sched = ContinuousScheduler(engines[0], clock=clock) if len(engines) == 1 else FleetRouter(engines, clock=clock)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        comps = sched.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        replicas = [dict(e.stats) for e in engines]
        # #5 runs only where a prefill worker sits on the card
        on_card = [r for r, e in zip(replicas, engines) if e.prefill.device.type == "cuda"]
        _launch_rule(f"fleet f32 {name}", counts, {"prefill_dispatches": sum(r["prefill_dispatches"] for r in on_card)},
                     0, False, "float32")
        used = sorted({c.replica for c in comps})
        if used != list(range(len(engines))):
            fail(f"fleet f32 {name}: replicas used {used}")
        for i, (d, e, r) in enumerate(zip(placement, engines, replicas)):
            # a pair apart: every handoff it made crossed from the CPU to the card
            if d is not None and (e.prefill.device.type != "cpu" or e.decode.device.type != "cuda"
                                  or r["handoffs"] == 0):
                fail(f"fleet f32 {name}: replica {i} prefill on {e.prefill.device}, decode on "
                     f"{e.decode.device}, {r['handoffs']} handoffs")
        out[name] = {c.rid: c.tokens for c in comps}
        print(f"fleet f32 {name}: {wall:.2f} s; per replica (prefills, handoffs, decode chunks) "
              f"{[(r['prefill_dispatches'], r['handoffs'], r['decode_chunks']) for r in replicas]}; router "
              f"{json.dumps(dict(sched.stats))}; launches {json.dumps({n: counts[n] for n in ATTN_KERNELS})}",
              flush=True)
    gates, smallest = _cold_gates(params, cfg, reqs, out["single"], where="fleet f32")
    for name in FLEET["arms"]:
        for rid, g in gates.items():
            if not np.array_equal(out[name][rid][:g], out["single"][rid][:g]):
                fail(f"fleet f32 {name}: rid {rid} tokens {out[name][rid].tolist()} != single engine "
                     f"{out['single'][rid].tolist()} before its first near-tie (position {g})")
    print(f"fleet f32 at full width: both fleets' tokens equal the single engine's on {sum(gates.values())} of "
          f"{sum(len(t) for t in out['single'].values())} positions (those before each request's first near-tie), "
          f"smallest top-2 margin {smallest:.3e}", flush=True)


def _serve_summary(result):
    return {k: result[k] for k in ("tok_per_s", "p50_s", "p95_s", "ttft_p50_s", "ttft_p95_s", "wall_s")}


def _served_in_full(where, result, vocab):
    comps = result["completions"]
    if len(comps) != SERVE["requests"] or any(len(c.tokens) != SERVE["gen"] for c in comps):
        fail(f"{where}: expected {SERVE['requests']} completions of {SERVE['gen']} tokens")
    if any(int(t) < 0 or int(t) >= vocab for c in comps for t in c.tokens):
        fail(f"{where}: token id out of the vocabulary")


def fleet_launcher(card):
    """bf16 through ``launch.serve`` at phase 5's settings: one engine and
    ``--replicas 2`` (two colocated replicas), in turns."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve

    tok_s = {"single": [], "fleet": []}
    undo = _counted_runs()
    try:
        for turn in ("single", "fleet", "fleet", "single"):
            fleet = turn == "fleet"
            result = serve.main(SERVE_ARGV + (["--replicas", "2"] if fleet else []))
            torch.cuda.synchronize()
            counts = launch_counts()
            where = f"fleet bf16 {turn}"
            _served_in_full(where, result, 49152)
            _launch_rule(where, counts, result["stats"], 0, False, "bfloat16")
            if fleet and (len(result["replicas"]) != 2 or min(r["admitted"] for r in result["replicas"]) == 0):
                fail(f"{where}: replicas {result['replicas']}")
            tok_s[turn].append(result["tok_per_s"])
            print(f"{where}: {json.dumps(_serve_summary(result))}; per replica (admitted, prefills, handoffs) "
                  f"{[(r['admitted'], r['prefill_dispatches'], r['handoffs']) for r in result['replicas']]}; router "
                  f"{json.dumps(result['router'])}; launches {json.dumps({n: counts[n] for n in ATTN_KERNELS})}",
                  flush=True)
    finally:
        undo()
    print(f"fleet bf16, launch.serve at phase 5's settings in turns single, fleet, fleet, single ({card}): tok/s "
          f"single {tok_s['single']}, --replicas 2 {tok_s['fleet']}; medians "
          f"{float(np.median(tok_s['single'])):.1f} and {float(np.median(tok_s['fleet'])):.1f}", flush=True)


def granite_path(card):
    """granite-3-2b at full width and depth: the f32 engine against the
    static generator, then the bf16 launcher at phase 5's settings."""
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    cfg = get_arch("granite-3-2b")
    f32 = cfg.replace(dtype="float32")
    params = init_lm(f32, torch.Generator(device=dev).manual_seed(1))
    params["embed"]["table"] *= 10.0  # tied: wide top-2 margins
    t0 = time.perf_counter()
    margin, compared, counts, stats = _engine_vs_static("granite-3-2b f32", f32, params, 4, 16, SERVE["prompt"],
                                                        gated=True)
    _launch_rule("granite-3-2b f32", counts, stats, 0, False, "float32", cfg.num_layers)
    print(f"granite-3-2b f32 at full width and depth ({cfg.num_layers} layers, d_model {cfg.d_model}): paged "
          f"engine == static generator on {compared} of 4x16 positions (those before each request's first "
          f"near-tie), smallest top-2 margin compared {margin:.3e}, "
          f"{time.perf_counter() - t0:.1f} s; launches {json.dumps({n: counts[n] for n in ATTN_KERNELS})}",
          flush=True)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    undo = _counted_runs()
    try:
        argv = [a if a != "smollm-135m" else "granite-3-2b" for a in SERVE_ARGV]
        result = serve.main(argv)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    _served_in_full("granite-3-2b bf16", result, cfg.vocab_size)
    _launch_rule("granite-3-2b bf16", counts, result["stats"], 0, False, "bfloat16", cfg.num_layers)
    print(f"granite-3-2b bf16, launch.serve at phase 5's settings ({card}): {json.dumps(_serve_summary(result))}; "
          f"max_memory_allocated {peak} bytes; prefills {result['stats']['prefill_dispatches']}; launches "
          f"{json.dumps({n: counts[n] for n in ATTN_KERNELS})}", flush=True)
    return {n: counts[n] for n in ATTN_KERNELS}


def internlm2_path():
    """internlm2-20b at full width, cut to INTERNLM2_LAYERS of its 48
    layers: the f32 engine against the static generator."""
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm
    from repro_torch.utils.trees import tree_leaves

    dev = torch.device("cuda")
    cfg = get_arch("internlm2-20b").replace(dtype="float32", num_layers=INTERNLM2_LAYERS)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    params["lm_head"]["kernel"] *= 10.0  # untied: wide top-2 margins
    n_params = sum(t.numel() for t in tree_leaves(params))
    t0 = time.perf_counter()
    margin, compared, counts, stats = _engine_vs_static("internlm2-20b f32", cfg, params, 4, 16, SERVE["prompt"],
                                                        gated=True)
    _launch_rule("internlm2-20b f32", counts, stats, 0, False, "float32", cfg.num_layers)
    print(f"internlm2-20b f32 at full width, {cfg.num_layers} of 48 layers ({n_params} parameters): paged engine == "
          f"static generator on {compared} of 4x16 positions (those before each request's first near-tie), smallest "
          f"top-2 margin compared {margin:.3e}, {time.perf_counter() - t0:.1f} s; "
          f"launches {json.dumps({n: counts[n] for n in ATTN_KERNELS})}", flush=True)


def rest_of_serving_path(card):
    t0 = time.perf_counter()
    fleet_f32()
    fleet_launcher(card)
    granite = granite_path(card)
    internlm2_path()
    print(f"rest-of-serving phase (5d): {time.perf_counter() - t0:.1f} s", flush=True)
    return granite


# ---------------------------------------------------------------------------
# phase 5e


def _free():
    """Collect what the caller dropped, hand the cached blocks back, and
    start the peak-memory count afresh."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _moe_engine_check(arch):
    """The f32 paged engine against the static generator at full width, the
    depth cut to ``MOE_CHECKS[arch]["layers"]``, a MoE at its ample capacity
    factor, the head x10 for wide margins. Returns (cfg, params)."""
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm
    from repro_torch.utils.trees import tree_leaves

    dev = torch.device("cuda")
    full = get_arch(arch)
    check = MOE_CHECKS[arch]
    cfg = full.replace(dtype="float32", num_layers=check["layers"])
    if check["factor"] is not None:
        cfg = cfg.replace(moe_capacity_factor=check["factor"])
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    params["lm_head"]["kernel"] *= 10.0  # untied: wide top-2 margins
    n_params = sum(t.numel() for t in tree_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    where = f"{arch} f32"
    margin, compared, counts, stats = _engine_vs_static(where, cfg, params, 4, 16, SERVE["prompt"], gated=True)
    _launch_rule(where, counts, stats, 0, False, "float32", cfg.num_layers)
    factor = "" if check["factor"] is None else f", capacity factor {cfg.moe_capacity_factor} (ample)"
    print(f"{where} at full width, {cfg.num_layers} of {full.num_layers} layers ({n_params} parameters{factor}): "
          f"paged engine == static generator on {compared} of 4x16 positions (those before each request's first "
          f"near-tie), smallest top-2 margin compared {margin:.3e}, {time.perf_counter() - t0:.1f} s; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; launches "
          f"{json.dumps({n: counts[n] for n in ATTN_KERNELS})}", flush=True)
    return cfg, params


def _mixtral_dispatch_check(cfg, moe_params):
    """One mixtral-8x7b MoE layer at full width on an 8 x 128 prefill-shaped
    input: einsum against scatter dispatch at the config's own factor 1.25
    and at a tight 0.5, where about half the slots drop (the same slots
    drop, so they agree within 1e-4 of the largest |y|), both against the
    dense oracle at the ample factor, a second scatter call bitwise; each
    dispatch timed in f32 and bf16 at 1.25 (CUDA events)."""
    import torch

    from repro_torch.models.moe import (
        _capacity, _group, _positions_in_expert, _router, moe_apply_einsum, moe_apply_scatter, moe_ref,
    )

    dev = torch.device("cuda")
    own = cfg.replace(moe_capacity_factor=1.25)
    x = torch.randn((DISPATCH["batch"], DISPATCH["seq"], cfg.d_model), generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    tokens = DISPATCH["batch"] * DISPATCH["seq"]

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    with torch.no_grad():
        xg, _ = _group(x, own, x.shape[1])
        _, idx, _ = _router(moe_params, xg, own)
        pos = _positions_in_expert(idx, own)
        found = {}
        for factor in (1.25, 0.5):
            c = cfg.replace(moe_capacity_factor=factor)
            cap = _capacity(c, xg.shape[1])
            y_e, aux_e = moe_apply_einsum(moe_params, x, c)
            y_s, aux_s = moe_apply_scatter(moe_params, x, c)
            gap = rel(y_s, y_e)
            if gap > 1e-4 or not torch.equal(aux_e, aux_s):
                fail(f"mixtral dispatch at factor {factor}: scatter is {gap:.3e} from einsum (aux {float(aux_e)}, "
                     f"{float(aux_s)})")
            if not torch.equal(moe_apply_scatter(moe_params, x, c)[0], y_s):
                fail(f"mixtral dispatch at factor {factor}: a second scatter call gave other bits")
            found[factor] = {"capacity": cap, "dropped": int((pos >= cap).sum()), "scatter_vs_einsum": gap}
        if found[0.5]["dropped"] == 0:
            fail("mixtral dispatch: nothing dropped at factor 0.5")
        y_r, _ = moe_ref(moe_params, x, cfg)
        ample = {n: rel(f(moe_params, x, cfg)[0], y_r) for n, f in (("einsum", moe_apply_einsum), ("scatter", moe_apply_scatter))}
        if max(ample.values()) > 1e-4:
            fail(f"mixtral dispatch at the ample factor {cfg.moe_capacity_factor}: gaps to moe_ref {ample}")
        times = {}
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            p = {n: (w if n == "router" else w.to(dt)) for n, w in moe_params.items()}
            xd = x.to(dt)
            for name, fn in (("einsum", moe_apply_einsum), ("scatter", moe_apply_scatter)):
                times[f"{name} {dname}"] = _time_ms(lambda: fn(p, xd, own), iters=10, warmup=2)
            del p
    print(f"mixtral-8x7b dispatch, one MoE layer at full width on {DISPATCH['batch']}x{DISPATCH['seq']} tokens "
          f"({tokens * cfg.experts_per_token} slots over {cfg.num_experts} experts), by capacity factor: "
          f"{json.dumps(found)} (gap of the largest |y|; aux equal, a second scatter call bitwise); at the ample "
          f"factor {cfg.moe_capacity_factor} vs moe_ref {json.dumps(ample)}; ms a call at 1.25 (CUDA events) "
          f"{json.dumps(times)}", flush=True)


def _mixtral_served(card):
    """A 4-layer mixtral-8x7b, registered under its own name in this
    process, through ``launch.serve`` in bf16 at phase 5's settings: every
    request returns its tokens, #5 launches 4 x the prefill dispatches on
    the tensor cores; then the same run under the profiler."""
    import torch

    from repro_torch.config.registry import get_arch, register_arch
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve

    name = f"mixtral-8x7b-{MIXTRAL_SERVED_LAYERS}l"
    cfg = register_arch(get_arch("mixtral-8x7b").replace(name=name, num_layers=MIXTRAL_SERVED_LAYERS))
    argv = [a if a != "smollm-135m" else name for a in SERVE_ARGV]
    torch.cuda.reset_peak_memory_stats()
    undo = _counted_runs()
    try:
        result = serve.main(argv)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    where = f"{name} bf16"
    _served_in_full(where, result, cfg.vocab_size)
    _launch_rule(where, counts, result["stats"], 0, False, "bfloat16", cfg.num_layers)
    prof = serve.main(argv + ["--profile"])
    busy, pwall = prof["device_busy_s"], prof["wall_s"]
    print(f"{where}, launch.serve at phase 5's settings ({card}): {json.dumps(_serve_summary(result))}; "
          f"max_memory_allocated {peak} bytes; prefills {result['stats']['prefill_dispatches']}; launches "
          f"{json.dumps({n: counts[n] for n in ATTN_KERNELS})}; profiled: device busy {busy:.3f} s of {pwall:.3f} s "
          f"wall, idle share {1 - busy / pwall:.3f}", flush=True)


def _qwen3_32b_full_depth(card):
    """qwen3-32b at full width and depth, the weights made directly in bf16
    (65.5 GB), through the launcher's paged engine on phase 5's stream
    (``launch.serve.run_continuous``: its f32 init would not fit). Where
    the card cannot hold it, the peak that failed is printed and the depth
    cut, 8 layers at a time, to the deepest that fits."""
    import torch

    from repro_torch import obs
    from repro_torch.config.registry import get_arch
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_lm
    from repro_torch.utils.trees import tree_leaves

    dev = torch.device("cuda")
    full = get_arch("qwen3-32b")
    args = serve.build_parser().parse_args([a if a != "smollm-135m" else full.name for a in SERVE_ARGV])
    obs.configure(metrics=False, trace=False, profile_dir=None, device=dev)
    for layers in range(full.num_layers, 0, -8):
        cfg = full.replace(num_layers=layers)
        params = None
        _free()
        try:
            params = init_lm(cfg, torch.Generator(device=dev).manual_seed(args.seed), param_dtype="bfloat16")
            n_params = sum(t.numel() for t in tree_leaves(params))
            undo = _counted_runs()
            try:
                result = serve.run_continuous(args, cfg, params)
                torch.cuda.synchronize()
                counts = launch_counts()
            finally:
                undo()
            break
        except torch.cuda.OutOfMemoryError:
            print(f"qwen3-32b bf16 at {layers} layers does not fit: max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()} bytes at the failure; cutting 8 layers", flush=True)
            params = None
    else:
        fail("qwen3-32b bf16: no depth fits the card")
    peak = torch.cuda.max_memory_allocated()
    where = f"qwen3-32b bf16, {layers} of {full.num_layers} layers"
    _served_in_full(where, result, cfg.vocab_size)
    _launch_rule(where, counts, result["stats"], 0, False, "bfloat16", cfg.num_layers)
    print(f"{where} ({n_params} parameters made in bf16), the paged engine on phase 5's stream ({card}): "
          f"{json.dumps(_serve_summary(result))}; max_memory_allocated {peak} bytes; prefills "
          f"{result['stats']['prefill_dispatches']}; launches {json.dumps({n: counts[n] for n in ATTN_KERNELS})}",
          flush=True)
    del params, result


def _loss_and_grads(cfg, params, batch):
    """``lm_loss`` and its gradients, flattened to ``a/b/c`` paths."""
    from repro_torch.models.transformer import lm_loss
    from repro_torch.utils.trees import flatten_dict, value_and_grad

    loss, grads = value_and_grad(lambda p: lm_loss(p, cfg, batch)[0], params)
    layers = grads.pop("layers")
    flat = flatten_dict(grads)
    for i, layer in enumerate(layers):
        flat.update({f"layers/{i}/{p}": g for p, g in flatten_dict(layer).items()})
    return loss, flat


def _remat_check(label, cfg, params, batch):
    """One f32 ``lm_loss`` step with ``remat`` against without: the same
    loss, every gradient within 1e-6 of its leaf's largest; #5 twice a
    layer under remat, once without; each arm's peak memory above what was
    allocated before its step (the weights, and the other arm's
    gradients)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    runs = {}
    for remat in (False, True):
        _free()
        base = torch.cuda.memory_allocated()
        reset_launch_counts()
        loss, grads = _loss_and_grads(cfg.replace(remat=remat), params, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = (2 if remat else 1) * cfg.num_layers
        if (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"]) != (want, cfg.num_layers):
            fail(f"{label} remat={remat}: launches {counts}, expected #5 {want} and #6 {cfg.num_layers}")
        runs[remat] = (loss, grads, torch.cuda.max_memory_allocated() - base)
        del grads
    (loss_r, grads_r, peak_r), (loss_p, grads_p, peak_p) = runs[True], runs[False]
    rel = {n: float((grads_r[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30) for n, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    if not torch.equal(loss_r, loss_p) or rel[worst] > 1e-6:
        fail(f"{label}: remat loss {float(loss_r)!r} vs {float(loss_p)!r}, largest gradient gap {rel[worst]:.3e} ({worst})")
    print(f"remat, {label}: loss {float(loss_r):.6f} equal with and without; largest gradient gap relative to the "
          f"leaf's largest {rel[worst]:.3e} ({worst}); peak memory above the step's start: remat {peak_r} bytes, "
          f"plain {peak_p} bytes ({peak_r / peak_p:.3f})", flush=True)


def remat_path():
    """``remat`` on the card: smollm-135m at full width (batch 8 x 256) and
    mixtral-8x7b at full width, 2 layers (batch 2 x 256), f32."""
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    m = REMAT_MIXTRAL
    for arch, (layers, b, seq) in (("smollm-135m", (None, TRAIN["batch"], TRAIN["seq"])),
                                   ("mixtral-8x7b", (m["layers"], m["batch"], m["seq"]))):
        cfg = get_arch(arch).replace(dtype="float32")
        if layers:
            cfg = cfg.replace(num_layers=layers)
        params = init_lm(cfg, torch.Generator(device=dev).manual_seed(6))
        batch = {n: torch.as_tensor(a, device=dev) for n, a in make_token_stream(6, cfg.vocab_size, b, seq).items()}
        _remat_check(f"{arch} f32, {cfg.num_layers} layers, batch {b} x {seq}", cfg, params, batch)
        del params, batch
        _free()


def moe_qk_norm_path(card):
    """Phase 5e: qwen3-32b, mixtral-8x7b and qwen3-moe-235b-a22b."""
    t0 = time.perf_counter()
    _moe_engine_check("qwen3-32b")
    _free()
    cfg, params = _moe_engine_check("mixtral-8x7b")
    _mixtral_dispatch_check(cfg, params["layers"][0]["moe"])
    del cfg, params
    _free()
    _moe_engine_check("qwen3-moe-235b-a22b")
    _free()
    _mixtral_served(card)
    _free()
    _qwen3_32b_full_depth(card)
    _free()
    remat_path()
    print(f"MoE and qk-norm phase (5e): {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 5f


def _attn_layers(cfg) -> int:
    """The attention layers of ``cfg`` (#5 launches once each a prefill)."""
    from repro_torch.models.transformer import layer_kinds

    return sum(1 for mixer, _ in layer_kinds(cfg) if mixer == "attn")


def _no_attention_launches(where, counts):
    if counts["flash_attention_fwd"] or counts["flash_decode"]:
        fail(f"{where}: an arch without attention launched #5 {counts['flash_attention_fwd']} and #8 "
             f"{counts['flash_decode']} times")


def _ragged_engine_vs_static(where, cfg, params, lens, gen, seed=1):
    """The paged engine's greedy tokens on prompts of lengths ``lens`` (a
    recurrent arch prefills each at its exact length, so #5 runs unpadded)
    against ``static_generate`` of each prompt alone, each request compared
    before its first near-tie (the static path's teacher-forced top-2
    margin at or below 1e-3); at least half of all positions compared.
    Returns the smallest margin compared, the positions compared, the
    engine's launches and its stats."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine, static_generate

    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    max_seq = -(-(max(lens) + gen) // SERVE["page"]) * SERVE["page"]
    ecfg = EngineConfig(max_slots=len(lens), max_seq=max_seq, max_new=gen, page_size=SERVE["page"], kv_layout="paged")
    eng = ServeEngine(cfg, params, ecfg)
    reset_launch_counts()
    comps = ContinuousScheduler(eng, clock=ManualClock()).run(
        [Request(rid=i, tokens=p, max_new_tokens=gen) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    counts = launch_counts()
    gates, smallest = [], float("inf")
    for c, p in zip(sorted(comps, key=lambda c: c.rid), prompts):
        tok = torch.as_tensor(p[None], device=dev)
        want = static_generate(params, cfg, {"tokens": tok}, gen)
        with torch.inference_mode():
            logits, _ = lm_forward(params, cfg, {"tokens": torch.cat([tok, want[:, :-1].to(tok.dtype)], 1)})
        top2 = logits[0, len(p) - 1:].topk(2, dim=-1).values
        m = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        del logits
        g = int(np.flatnonzero(m <= NEAR_TIE)[0]) if (m <= NEAR_TIE).any() else gen
        want = want[0].cpu().numpy()
        if not np.array_equal(c.tokens[:g], want[:g]):
            fail(f"{where}: request {c.rid} (prompt {len(p)}): engine tokens {c.tokens.tolist()} != static "
                 f"{want.tolist()} before position {g}")
        gates.append(g)
        if g:
            smallest = min(smallest, float(m[:g].min()))
    if sum(gates) < len(lens) * gen / 2:
        fail(f"{where}: near-ties leave {sum(gates)} of {len(lens) * gen} positions to compare (gates {gates})")
    return smallest, sum(gates), counts, dict(eng.stats)


def _recurrent_served(argv, cfg, params=None):
    """``launch.serve`` at phase 5's settings in bf16 (``params``: weights
    made by the caller, through ``run_continuous``), the counters reset
    when the timed run starts: every request returns its tokens; #5 once an
    attention layer for every prefill dispatch, #8 in the decode chunks
    (both never for an arch without attention). Returns the result, the
    launches and the peak memory."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    undo = _counted_runs()
    try:
        if params is None:
            result = serve.main(argv)
        else:
            obs.configure(metrics=False, trace=False, profile_dir=None, device=torch.device("cuda"))
            result = serve.run_continuous(serve.build_parser().parse_args(argv), cfg, params)
        torch.cuda.synchronize()
        counts = {n: launch_counts()[n] for n in ATTN_KERNELS}
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    where = f"{cfg.name} bf16, {cfg.num_layers} layers"
    _served_in_full(where, result, cfg.vocab_size)
    layers = _attn_layers(cfg)
    if layers:
        _launch_rule(where, launch_counts(), result["stats"], 0, False, "bfloat16", layers)
    else:
        _no_attention_launches(where, counts)
    return result, counts, peak


def _prefill_cost(cfg, params, batch):
    """Host clock around one ``lm_prefill`` of ``batch`` prompts of phase
    5's length (after a warm-up call), and the same call under the
    profiler: ms per prompt token of the step loop, and the device's idle
    share."""
    import torch

    from repro_torch.models.transformer import init_lm_state, lm_prefill
    from repro_torch.utils.device import profiled
    from repro_torch.utils.logging import get_logger

    dev = torch.device("cuda")
    tokens = torch.randint(0, cfg.vocab_size, (batch, SERVE["prompt"]), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(4))

    def run():
        with torch.inference_mode():
            state = init_lm_state(cfg, batch, SERVE["prompt"] + SERVE["gen"], device=dev)
            lm_prefill(params, cfg, {"tokens": tokens}, state)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    _, busy, pwall = profiled(run, get_logger("chip_smoke"))
    return {"batch": batch, "ms": wall * 1e3, "ms_per_prompt_token": wall * 1e3 / SERVE["prompt"],
            "device_busy_ms": busy * 1e3, "idle_share": 1 - busy / pwall}


def _chunk_checkpoint_check(cfg):
    """One f32 ``lm_loss`` step of xlstm-125m at full width (batch
    RECURRENT_TRAIN["check_batch"] x seq: two scan chunks), with the chunk
    checkpoint of ``chunked_scan`` on (the model's) and off (``xlstm``'s
    scan patched to ``use_checkpoint=False``), layer remat off in both: the
    same loss, every gradient within 1e-6 of its leaf's largest; each arm's
    peak memory above the step's start."""
    import functools

    import torch

    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.models import xlstm
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    cfg = cfg.replace(dtype="float32", remat=False)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(6))
    b = RECURRENT_TRAIN["check_batch"]
    batch = {n: torch.as_tensor(a, device=dev)
             for n, a in make_token_stream(6, cfg.vocab_size, b, RECURRENT_TRAIN["seq"]).items()}
    scan = xlstm.chunked_scan
    runs = {}
    try:
        for on in (True, False):
            xlstm.chunked_scan = scan if on else functools.partial(scan, use_checkpoint=False)
            _free()
            base = torch.cuda.memory_allocated()
            loss, grads = _loss_and_grads(cfg, params, batch)
            torch.cuda.synchronize()
            runs[on] = (loss, grads, torch.cuda.max_memory_allocated() - base)
            del grads
    finally:
        xlstm.chunked_scan = scan
    (loss_c, grads_c, peak_c), (loss_p, grads_p, peak_p) = runs[True], runs[False]
    rel = {n: float((grads_c[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30) for n, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    if not torch.equal(loss_c, loss_p) or rel[worst] > 1e-6:
        fail(f"chunk checkpoint: loss {float(loss_c)!r} vs {float(loss_p)!r}, largest gradient gap {rel[worst]:.3e} "
             f"({worst})")
    print(f"chunked_scan checkpoint, xlstm-125m f32 at full width, batch {b} x {RECURRENT_TRAIN['seq']} "
          f"({RECURRENT_TRAIN['seq'] // cfg.ssm_chunk} chunks of {cfg.ssm_chunk}): loss {float(loss_c):.6f} equal "
          f"on and off; largest gradient gap relative to the leaf's largest {rel[worst]:.3e} ({worst}); peak memory "
          f"above the step's start: checkpointed {peak_c} bytes, plain {peak_p} bytes ({peak_c / peak_p:.3f})",
          flush=True)


def _xlstm_path(card):
    """xlstm-125m: the f32 engine against the static generator at full
    width and depth, the bf16 launcher at phase 5's settings with the
    prefill's cost, ``launch.train`` and the chunk checkpoint."""
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch, register_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models.transformer import cast_weights, init_lm
    from repro_torch.utils.trees import tree_leaves

    dev = torch.device("cuda")
    full = get_arch("xlstm-125m")
    f32 = full.replace(dtype="float32")
    params = init_lm(f32, torch.Generator(device=dev).manual_seed(1))
    params["embed"]["table"] *= 10.0  # tied: wide top-2 margins
    n_params = sum(t.numel() for t in tree_leaves(params))
    t0 = time.perf_counter()
    margin, compared, counts, stats = _engine_vs_static("xlstm-125m f32", f32, params, 4, 16, SERVE["prompt"],
                                                        gated=True, attention=False)
    _no_attention_launches("xlstm-125m f32", counts)
    print(f"xlstm-125m f32 at full width and depth ({full.num_layers} layers, {n_params} parameters): the engine "
          f"(paged requested, dense run) == static generator on {compared} of 4x16 positions (those before each "
          f"request's first near-tie), smallest top-2 margin compared {margin:.3e}, {stats['prefill_dispatches']} "
          f"prefills, {time.perf_counter() - t0:.1f} s; launches {json.dumps({n: counts[n] for n in ATTN_KERNELS})}",
          flush=True)
    del params
    _free()
    argv = [a if a != "smollm-135m" else full.name for a in SERVE_ARGV]
    result, counts, peak = _recurrent_served(argv, full)
    bf16 = cast_weights(init_lm(full, torch.Generator(device=dev).manual_seed(0)), full)
    cost = [_prefill_cost(full, bf16, b) for b in (1, SERVE["slots"])]
    del bf16
    print(f"xlstm-125m bf16, launch.serve at phase 5's settings ({card}): {json.dumps(_serve_summary(result))}; "
          f"max_memory_allocated {peak} bytes; prefills {result['stats']['prefill_dispatches']}; launches "
          f"{json.dumps(counts)}; one lm_prefill of {SERVE['prompt']} tokens (host clock; profiled idle share) "
          f"{json.dumps(cost)}", flush=True)
    _free()
    # depth cut to one sLSTM group: the step is a host loop over time, a few
    # seconds a layer
    cut = register_arch(full.replace(name=f"{full.name}-{RECURRENT_TRAIN['layers']}l",
                                     num_layers=RECURRENT_TRAIN["layers"]))
    argv = ["--arch", cut.name, "--batch", str(RECURRENT_TRAIN["batch"]), "--seq", str(RECURRENT_TRAIN["seq"]),
            "--steps", str(RECURRENT_TRAIN["steps"]), "--optimizer", "adamw", "--device", "cuda",
            "--log-every", "1"]
    reset_launch_counts()
    result = train.main(argv)
    torch.cuda.synchronize()
    _no_attention_launches("xlstm-125m training", launch_counts())
    if not all(math.isfinite(x) for x in result["losses"]):
        fail(f"xlstm-125m training: non-finite loss in {result['losses']}")
    summary = {k: result[k] for k in ("s_per_step", "tok_per_s", "max_memory_bytes", "params")}
    print(f"xlstm-125m training, {cut.num_layers} of {full.num_layers} layers, launch.train in bf16 under remat, "
          f"batch {RECURRENT_TRAIN['batch']} x "
          f"{RECURRENT_TRAIN['seq']} ({RECURRENT_TRAIN['seq'] // full.ssm_chunk} scan chunks of {full.ssm_chunk}), "
          f"{RECURRENT_TRAIN['steps']} steps ({card}): {json.dumps(summary)}; losses "
          f"{[round(x, 4) for x in result['losses']]}", flush=True)
    _free()
    _chunk_checkpoint_check(full)
    _free()
    return float(np.mean(result["losses"]))


def _jamba_path(card):
    """jamba-v0.1-52b: the f32 paged engine with recurrent rows against the
    static generator at full width, RECURRENT_JAMBA["layers"] layers, on
    ragged prompts; then the deepest multiple of 8 layers that fits in
    bf16 through the launcher's engine. Returns the launches of both."""
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_lm
    from repro_torch.utils.trees import tree_leaves

    dev = torch.device("cuda")
    full = get_arch("jamba-v0.1-52b")
    j = RECURRENT_JAMBA
    cfg = full.replace(dtype="float32", num_layers=j["layers"], moe_capacity_factor=j["factor"])
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    params["lm_head"]["kernel"] *= 10.0  # untied: wide top-2 margins
    n_params = sum(t.numel() for t in tree_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    where = "jamba-v0.1-52b f32"
    margin, compared, counts, stats = _ragged_engine_vs_static(where, cfg, params, j["lens"], 16)
    _launch_rule(where, counts, stats, 0, False, "float32", _attn_layers(cfg))
    f32_counts = {n: counts[n] for n in ATTN_KERNELS}
    print(f"{where} at full width, {cfg.num_layers} of {full.num_layers} layers ({n_params} parameters, capacity "
          f"factor {cfg.moe_capacity_factor}), ragged prompts {list(j['lens'])}: the paged engine with recurrent "
          f"rows == static generator on {compared} of {len(j['lens'])}x16 positions (those before each request's "
          f"first near-tie), smallest top-2 margin compared {margin:.3e}; #5 = {_attn_layers(cfg)} attention "
          f"layer(s) x {stats['prefill_dispatches']} prefills, at the prompts' own lengths; "
          f"{time.perf_counter() - t0:.1f} s; max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; "
          f"launches {json.dumps(f32_counts)}", flush=True)
    # the parameters of a group of 8 layers, from the f32 check's count: a
    # depth whose bf16 weights alone exceed the card is not tried
    outside = sum(t.numel() for k, v in params.items() if k != "layers" for t in tree_leaves(v))
    per_group = (n_params - outside) // (cfg.num_layers // 8)
    del params
    argv = [a if a != "smollm-135m" else full.name for a in SERVE_ARGV]
    seed = serve.build_parser().parse_args(argv).seed
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    for layers in range(full.num_layers, 0, -8):
        if 2 * (outside + per_group * layers // 8) > card_bytes:
            print(f"jamba-v0.1-52b bf16 at {layers} layers: {2 * (outside + per_group * layers // 8)} bytes of "
                  f"weights exceed the card's {card_bytes}; cutting 8 layers", flush=True)
            continue
        cfg = full.replace(num_layers=layers)
        params = None
        _free()
        try:
            params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), param_dtype="bfloat16")
            n_params = sum(t.numel() for t in tree_leaves(params))
            result, counts, peak = _recurrent_served(argv, cfg, params)
            break
        except torch.cuda.OutOfMemoryError:
            print(f"jamba-v0.1-52b bf16 at {layers} layers does not fit: max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()} bytes at the failure; cutting 8 layers", flush=True)
            params = None
    else:
        fail("jamba-v0.1-52b bf16: no depth fits the card")
    print(f"jamba-v0.1-52b bf16, {layers} of {full.num_layers} layers ({n_params} parameters made in bf16), the "
          f"paged engine on phase 5's stream ({card}): {json.dumps(_serve_summary(result))}; max_memory_allocated "
          f"{peak} bytes; prefills {result['stats']['prefill_dispatches']}; launches {json.dumps(counts)} "
          f"(#5 = {_attn_layers(cfg)} attention layers x prefills)", flush=True)
    cost = _prefill_cost(cfg, params, SERVE["slots"])
    print(f"jamba-v0.1-52b bf16, {layers} layers: one lm_prefill of {SERVE['slots']} x {SERVE['prompt']} tokens "
          f"(host clock; profiled idle share) {json.dumps(cost)}", flush=True)
    del params, result
    return f32_counts, counts


def recurrent_path(card):
    """Phase 5f: xlstm-125m and jamba-v0.1-52b."""
    t0 = time.perf_counter()
    _xlstm_path(card)
    _free()
    f32_counts, bf16_counts = _jamba_path(card)
    _free()
    print(f"recurrent phase (5f): {time.perf_counter() - t0:.1f} s", flush=True)
    return bf16_counts


# ---------------------------------------------------------------------------
# phase 5g


def _frames_batch(cfg, b, seed):
    """hubert's input: ``b`` x 500 frame features (``frontend_dim`` each) and
    codebook labels, from ``seed`` with numpy."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    frames = rng.randn(b, HUBERT["frames"], cfg.frontend_dim).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, size=(b, HUBERT["frames"]))
    dev = torch.device("cuda")
    return {"frames": torch.as_tensor(frames, device=dev), "labels": torch.as_tensor(labels, device=dev)}


def _train_launches(where, counts, layers, steps, dtype):
    """A training run under remat: #5 twice a layer a step (its recompute),
    #6 and #7 once, on the kernels of ``dtype``."""
    _check_variants(where, counts, dtype)
    want = {"flash_attention_fwd": 2 * layers * steps, "flash_attention_bwd_dq": layers * steps,
            "flash_attention_bwd_dkv": layers * steps, "flash_decode": 0}
    if any(counts[n] != w for n, w in want.items()):
        fail(f"{where}: launches {json.dumps({n: counts[n] for n in want})}, expected {json.dumps(want)}")


def _hubert_path(card):
    """hubert-xlarge at full width and depth: one f32 ``lm_loss`` step
    through the kernels against plain autograd, then 10 AdamW steps with
    bf16 activations through ``runtime.steps``' train step."""
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.config.train import TrainConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_lm
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.utils.trees import tree_leaves

    dev = torch.device("cuda")
    full = get_arch("hubert-xlarge")
    cfg = full.replace(dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(7))
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = _frames_batch(cfg, HUBERT["batch"], seed=7)
    where = f"hubert-xlarge f32, {HUBERT['batch']} x {HUBERT['frames']} frames"
    t0 = time.perf_counter()
    reset_launch_counts()
    loss_k, got = _loss_and_grads(cfg.replace(backend="cuda"), params, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    _train_launches(where, counts, cfg.num_layers, 1, "float32")
    loss_r, want = _loss_and_grads(cfg.replace(backend="ref"), params, batch)
    rel_loss = abs(float(loss_k) - float(loss_r)) / abs(float(loss_r))
    rel = {n: float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30) for n, w in want.items()}
    worst = max(rel, key=rel.get)
    if not all(bool(torch.isfinite(g).all()) for g in got.values()):
        fail(f"{where}: a gradient through the kernels is not finite")
    if rel_loss > 1e-5 or rel[worst] > 1e-3:
        fail(f"{where}: loss {float(loss_k)!r} vs plain {float(loss_r)!r} ({rel_loss:.3e} relative), largest "
             f"gradient gap {rel[worst]:.3e} of the leaf's largest ({worst})")
    print(f"{where} at full width and depth ({cfg.num_layers} layers, {n_params} parameters), lm_loss and its "
          f"gradients through the kernels vs plain autograd: loss {float(loss_k):.6f} vs {float(loss_r):.6f} "
          f"({rel_loss:.3e} relative, limit 1e-5); largest gradient gap relative to the leaf's largest "
          f"{rel[worst]:.3e} ({worst}; limit 1e-3), median {float(np.median(list(rel.values()))):.3e}; "
          f"{time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps({n: counts[n] for n in TRAIN_KERNELS})}", flush=True)
    del got, want
    _free()
    steps = HUBERT["steps"]
    tc = TrainConfig(optimizer="adamw", learning_rate=3e-3, schedule="linear_warmup_cosine", warmup_steps=1,
                     total_steps=steps)
    step_fn = make_train_step(full, tc)
    opt_state = step_fn.optimizer.init(params)
    batches = [_frames_batch(full, HUBERT["train_batch"], seed=100 + i) for i in range(steps)]
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, stamps = [], []
    for i, b in enumerate(batches):
        params, opt_state, metrics = step_fn(params, opt_state, b, i)
        losses.append(float(metrics["loss"]))  # a host read: the step has finished
        stamps.append(time.perf_counter())
    counts = launch_counts()
    where = f"hubert-xlarge training, bf16 activations, {HUBERT['train_batch']} x {HUBERT['frames']} frames"
    _train_launches(where, counts, full.num_layers, steps, "bfloat16")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{where}: non-finite loss in {losses}")
    s_step = (stamps[-1] - stamps[0]) / (steps - 1)  # after the first step
    print(f"{where}, AdamW, {steps} steps through runtime.steps under remat ({card}): {s_step:.4f} s/step, "
          f"{HUBERT['train_batch'] * HUBERT['frames'] / s_step:.1f} frames/s after the first step, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; losses {[round(x, 4) for x in losses]}; "
          f"launches {json.dumps({n: counts[n] for n in TRAIN_KERNELS})}", flush=True)
    del params, opt_state, batches


def _phi_batch(cfg, b, prompt, seed):
    """phi's serving input as the launcher makes it: the token stream's
    prompts and ``RandomState(seed).randn(b, P, frontend_dim) x 0.02``."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_token_stream

    dev = torch.device("cuda")
    tokens = make_token_stream(seed, cfg.vocab_size, b, prompt)["tokens"][:, :prompt]
    prefix = np.random.RandomState(seed).randn(b, cfg.num_prefix_tokens, cfg.frontend_dim).astype(np.float32) * 0.02
    return {"tokens": torch.as_tensor(tokens, device=dev), "prefix": torch.as_tensor(prefix, device=dev)}


def _phi_static_check():
    """phi-3-vision-4.2b in f32 at full width and depth: ``static_generate``
    through the kernels against the plain attention on the seeded prefix,
    each prompt compared before its first near-tie (the plain route's
    teacher-forced top-2 margin at or below 1e-3); #5 once a layer, #8
    never (the static path decodes densely)."""
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_lm, lm_forward
    from repro_torch.serve import static_generate
    from repro_torch.utils.trees import tree_leaves

    dev = torch.device("cuda")
    full = get_arch("phi-3-vision-4.2b")
    cfg = full.replace(dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    params["lm_head"]["kernel"] *= 10.0  # untied: wide top-2 margins
    n_params = sum(t.numel() for t in tree_leaves(params))
    n, prompt, gen, pre = PHI["prompts"], PHI["prompt"], PHI["gen"], cfg.num_prefix_tokens
    batch = _phi_batch(cfg, n, prompt, seed=1)
    where = f"phi-3-vision-4.2b f32, {n} prompts of {prompt} tokens after {pre} patches"
    t0 = time.perf_counter()
    reset_launch_counts()
    got = static_generate(params, cfg.replace(backend="auto"), batch, gen)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = static_generate(params, cfg.replace(backend="ref"), batch, gen)
    _check_variants(where, counts, "float32")
    if (counts["flash_attention_fwd"], counts["flash_decode"]) != (cfg.num_layers, 0):
        fail(f"{where}: #5 launched {counts['flash_attention_fwd']} times and #8 {counts['flash_decode']}, expected "
             f"{cfg.num_layers} (one prefill) and 0")
    with torch.inference_mode():  # the logits behind each plain token, teacher-forced
        logits, _ = lm_forward(params, cfg.replace(backend="ref"),
                               {"tokens": torch.cat([batch["tokens"], want[:, :-1].to(batch["tokens"].dtype)], 1),
                                "prefix": batch["prefix"]})
    top2 = logits[:, pre + prompt - 1:].topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    del logits
    gates = [int(np.flatnonzero(m <= NEAR_TIE)[0]) if (m <= NEAR_TIE).any() else gen for m in margins]
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if not all(np.array_equal(a[:g], b[:g]) for a, b, g in zip(got, want, gates)):
        fail(f"{where}: kernel route tokens {got.tolist()} != plain route {want.tolist()} (compared before "
             f"positions {gates})")
    if sum(gates) < n * gen / 2:
        fail(f"{where}: near-ties leave {sum(gates)} of {n * gen} positions to compare (gates {gates})")
    margin = float(min(m[:g].min() for m, g in zip(margins, gates) if g))
    print(f"{where} at full width and depth ({cfg.num_layers} layers, {n_params} parameters, head x10): "
          f"static_generate through #5 == the plain route on {sum(gates)} of {n}x{gen} positions (those before each "
          f"prompt's first near-tie), smallest top-2 margin compared {margin:.3e}; {time.perf_counter() - t0:.1f} s; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; launches "
          f"{json.dumps({n: counts[n] for n in ATTN_KERNELS})}", flush=True)
    del params


def _phi_served(card):
    """phi-3-vision-4.2b in bf16 through ``launch.serve --engine static``
    (8 prompts of 128 tokens, 64 new; the launcher runs the batch twice,
    a warm-up and the timed run): #5 once a layer a run, #8 never; then
    one ``lm_prefill`` of the same 8 x (576 + 128) positions, its weights
    made in bf16, timed on the host clock (median of 3), and one
    ``static_generate`` of that batch under the profiler (the device's busy
    and idle share)."""
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_lm, init_lm_state, lm_prefill
    from repro_torch.serve import static_generate
    from repro_torch.utils.device import profiled
    from repro_torch.utils.logging import get_logger

    dev = torch.device("cuda")
    full = get_arch("phi-3-vision-4.2b")
    b, prompt, gen = PHI["batch"], PHI["prompt"], PHI["gen"]
    argv = ["--arch", full.name, "--engine", "static", "--batch", str(b), "--prompt-len", str(prompt), "--gen",
            str(gen), "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    result = serve.main(argv)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    where = f"phi-3-vision-4.2b bf16, launch.serve --engine static --batch {b} --prompt-len {prompt} --gen {gen}"
    _check_variants(where, counts, "bfloat16")
    if (counts["flash_attention_fwd"], counts["flash_decode"]) != (2 * full.num_layers, 0):
        fail(f"{where}: #5 launched {counts['flash_attention_fwd']} times and #8 {counts['flash_decode']}, expected "
             f"{2 * full.num_layers} (a warm-up and a timed prefill) and 0")
    if len(result["sample"]) != gen or not all(0 <= t < full.vocab_size for t in result["sample"]):
        fail(f"{where}: sample continuation {result['sample']}")
    _free()
    params = init_lm(full, torch.Generator(device=dev).manual_seed(0), param_dtype="bfloat16")
    batch = _phi_batch(full, b, prompt, seed=0)
    sq = full.num_prefix_tokens + prompt
    walls = []
    for _ in range(4):  # a warm-up, then three timed
        with torch.inference_mode():
            state = init_lm_state(full, b, sq + gen, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm_prefill(params, full, batch, state)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        del state
    prefill_ms = float(np.median(walls[1:])) * 1e3
    _, busy, pwall = profiled(lambda: static_generate(params, full, batch, gen).cpu(), get_logger("chip_smoke"))
    print(f"{where} ({card}): {result['tok_per_s']:.1f} tok/s ({result['tokens']:.0f} tokens in "
          f"{result['wall_s']:.3f} s, prefill and decode); max_memory_allocated {peak} bytes (the f32 init and its "
          f"bf16 cast included); launches {json.dumps({n: counts[n] for n in ATTN_KERNELS})}; one lm_prefill of "
          f"{b} x {sq} positions (Sq = {sq}), weights made in bf16: {prefill_ms:.3f} ms (host clock, median of 3; "
          f"{[round(w * 1e3, 3) for w in walls[1:]]}); static_generate of that batch profiled: device busy "
          f"{busy:.4f} s of {pwall:.4f} s wall (idle share {1 - busy / pwall:.3f})", flush=True)
    del params, batch


def _phi_training(card):
    """phi-3-vision-4.2b through ``launch.train`` at full width in bf16 with
    AdamW (f32 params and state), 8 x 256 text tokens after 576 patches, 5
    steps, at the deepest multiple of 8 layers whose estimated peak (8 f32
    copies of the parameters while AdamW updates them, and 8 GB of
    activations) fits the card, cut by 8 more on an out-of-memory error; the
    depth is printed."""
    import torch

    from repro_torch.config.registry import get_arch, register_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train

    full = get_arch("phi-3-vision-4.2b")
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    steps = PHI["train_steps"]
    for layers in range(full.num_layers, 0, -8):
        cfg = full.replace(name=f"phi-3-vision-4.2b-{layers}l", num_layers=layers)
        estimate = 8 * 4 * cfg.param_count() + 8e9
        if estimate > card_bytes:
            print(f"phi-3-vision-4.2b training at {layers} layers: an estimated peak of {estimate:.4g} bytes exceeds "
                  f"the card's {card_bytes}; cutting 8 layers", flush=True)
            continue
        register_arch(cfg)  # under its own name in this process, as phase 6 registers its variant
        _free()
        reset_launch_counts()
        try:
            result = train.main(["--arch", cfg.name, "--batch", str(PHI["train_batch"]), "--seq",
                                 str(PHI["train_seq"]), "--steps", str(steps), "--optimizer", "adamw", "--device",
                                 "cuda", "--log-every", "1"])
            break
        except torch.cuda.OutOfMemoryError:
            print(f"phi-3-vision-4.2b training at {layers} layers does not fit: max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()} bytes at the failure; cutting 8 layers", flush=True)
    else:
        fail("phi-3-vision-4.2b training: no depth fits the card")
    torch.cuda.synchronize()
    counts = launch_counts()
    where = f"phi-3-vision-4.2b training, {layers} of {full.num_layers} layers"
    _train_launches(where, counts, layers, steps, "bfloat16")
    if not all(math.isfinite(x) for x in result["losses"]):
        fail(f"{where}: non-finite loss in {result['losses']}")
    summary = {k: result[k] for k in ("s_per_step", "tok_per_s", "max_memory_bytes", "params")}
    print(f"{where} (depth cut to fit AdamW's f32 state), launch.train in bf16 under remat, "
          f"{PHI['train_batch']} x {PHI['train_seq']} text tokens after {full.num_prefix_tokens} patches, {steps} "
          f"steps ({card}): {json.dumps(summary)} (tok/s counts text tokens); losses "
          f"{[round(x, 4) for x in result['losses']]}; launches {json.dumps({n: counts[n] for n in TRAIN_KERNELS})}",
          flush=True)


def modality_path(card):
    """Phase 5g: hubert-xlarge and phi-3-vision-4.2b."""
    t0 = time.perf_counter()
    _hubert_path(card)
    _free()
    _phi_static_check()
    _free()
    _phi_served(card)
    _free()
    _phi_training(card)
    _free()
    print(f"modality phase (5g): {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 5b


# ---------------------------------------------------------------------------
# phase 5h


def _mesh_engine_f32(host):
    """Full width in f32: the sharded engine's greedy tokens against the
    meshless engine's, every position, with #5 and #8 on the local route."""
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.dispatch import LOCAL_MAP_CALLS, reset_local_map_calls
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine

    dev = torch.device("cuda")
    cfg = get_arch("smollm-135m").replace(dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    params["embed"]["table"] *= 10.0
    n, gen, prompt = 4, 16, SERVE["prompt"]
    tokens = make_token_stream(1, cfg.vocab_size, n, prompt)["tokens"]
    ecfg = EngineConfig(max_slots=n, max_seq=prompt + gen, max_new=gen, page_size=SERVE["page"], kv_layout="paged")

    def run(mesh):
        eng = ServeEngine(cfg, params, ecfg, mesh=mesh)
        comps = ContinuousScheduler(eng, clock=ManualClock()).run(
            [Request(rid=i, tokens=tokens[i], max_new_tokens=gen) for i in range(n)]
        )
        return np.stack([c.tokens for c in comps])

    want = run(None)
    reset_launch_counts()
    reset_local_map_calls()
    got = run(host)
    counts, route = launch_counts(), dict(LOCAL_MAP_CALLS)
    if not np.array_equal(got, want):
        fail(f"sharded engine f32: tokens {got.tolist()} != meshless engine {want.tolist()}")
    for name, key in (("flash_attention_fwd", "flash_attention"), ("flash_decode", "flash_decode")):
        if counts[name] == 0 or route[key] == 0:
            fail(f"sharded engine f32: {name} launched {counts[name]} times, {route[key]} calls on the local route")
    print(f"sharded engine f32 on the 1x1 mesh: tokens equal to the meshless engine's on {n}x{gen} positions; "
          f"launches {json.dumps({k: counts[k] for k in ATTN_KERNELS})}, local_map calls {json.dumps(route)}", flush=True)
    del params


def _mesh_serving_turns(host, card):
    """bf16 at phase 5's settings through ``launch.serve.run_continuous``,
    meshless and sharded in turns: tok/s of each (printed, not gated)."""
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.transformer import cast_weights, init_lm

    args = serve.build_parser().parse_args(SERVE_ARGV)
    cfg = get_arch(args.arch).replace(backend=args.backend)
    params = cast_weights(init_lm(cfg, torch.Generator(device="cuda").manual_seed(args.seed)), cfg)
    rates = {"meshless": [], "sharded": []}
    for turn in MESH_TURNS:
        result = serve.run_continuous(args, cfg, params, host if turn == "sharded" else None)
        torch.cuda.synchronize()
        if len(result["completions"]) != SERVE["requests"] or any(len(c.tokens) != SERVE["gen"] for c in result["completions"]):
            fail(f"sharded serving bf16 ({turn}): expected {SERVE['requests']} completions of {SERVE['gen']} tokens")
        rates[turn].append(result["tok_per_s"])
    print(f"sharded serving bf16 at phase 5's settings, turns {'/'.join(MESH_TURNS)} ({card}): tok/s "
          f"{json.dumps(rates)}", flush=True)
    return rates


def _mesh_train(host, card):
    """The train step at full width under the 1x1 mesh: f32 losses against
    the meshless step's, then bf16 s/step in turns."""
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.config.train import TrainConfig
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.dispatch import LOCAL_MAP_CALLS, reset_local_map_calls
    from repro_torch.models.transformer import init_lm
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.sharding import mesh_context, shard_params

    dev = torch.device("cuda")
    steps = MESH_TRAIN["steps"]
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in make_token_stream(i, 49152, MESH_TRAIN["batch"], MESH_TRAIN["seq"]).items()}
               for i in range(steps)]
    tc = TrainConfig(optimizer="adamw", learning_rate=3e-3, schedule="linear_warmup_cosine", warmup_steps=1,
                     total_steps=steps)

    def run(cfg, mesh):
        step = make_train_step(cfg, tc)
        params = init_lm(cfg, torch.Generator(device=dev).manual_seed(5))
        if mesh is not None:
            params = shard_params(params, mesh)
        opt = step.optimizer.init(params)
        losses, t0 = [], None
        for i, batch in enumerate(batches):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with mesh_context(mesh):
                params, opt, metrics = step(params, opt, batch, i)
            losses.append(float(metrics["loss"]))
        return losses, (time.perf_counter() - t0) / (steps - 1)

    cfg = get_arch("smollm-135m").replace(dtype="float32")
    want, _ = run(cfg, None)
    reset_launch_counts()
    reset_local_map_calls()
    got, _ = run(cfg, host)
    counts, route = launch_counts(), dict(LOCAL_MAP_CALLS)
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"sharded train step f32 on the 1x1 mesh: losses {got} (meshless {want}), largest relative gap {gap:.3e}; "
          f"launches {json.dumps({k: counts[k] for k in TRAIN_KERNELS})}, local_map calls {json.dumps(route)}", flush=True)
    if gap > 1e-5:
        fail(f"sharded train step f32: losses {got} beyond 1e-5 relative of the meshless step's {want}")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if counts[name] == 0:
            fail(f"sharded train step f32 never launched {name}")
    if route["flash_attention"] == 0:
        fail("sharded train step f32: the attention kernels never ran through the local_map route")
    bf16 = get_arch("smollm-135m")
    s_per_step = {"meshless": [], "sharded": []}
    for turn in MESH_TURNS:
        reset_launch_counts()
        losses, sps = run(bf16, host if turn == "sharded" else None)
        if not all(math.isfinite(x) for x in losses):
            fail(f"sharded train step bf16 ({turn}): non-finite loss in {losses}")
        if turn == "sharded":
            _check_variants("sharded train step bf16", launch_counts(), "bfloat16")
        s_per_step[turn].append(sps)
    print(f"sharded train step bf16, {MESH_TRAIN['batch']}x{MESH_TRAIN['seq']} tokens, turns {'/'.join(MESH_TURNS)} "
          f"({card}): s/step after the first {json.dumps(s_per_step)}", flush=True)
    return np.median(s_per_step["sharded"]), np.median(s_per_step["meshless"])


def mesh_path(card):
    """Phase 5h: the mesh modules on one card, as a world of one."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import disagg_submeshes, init_distributed, make_fleet_mesh, make_host_mesh, replica_meshes

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if init_distributed("cuda", init_method=f"file://{tmp}/rendezvous") != 1:
            fail("mesh phase: expected a world of one")
        host = make_host_mesh("cuda")
        subs = replica_meshes(make_fleet_mesh(1, device_type="cuda"))
        pm, dm = disagg_submeshes(subs[0])
        if len(subs) != 1 or tuple(subs[0].mesh.shape) != (1, 1) or not (pm is dm is subs[0]):
            fail(f"mesh phase: degenerate topology {[tuple(m.mesh.shape) for m in subs]}, halves colocated {pm is dm}")
        print("mesh topology on one card: make_fleet_mesh(1) gives one (1, 1) replica, disagg_submeshes its own "
              "mesh twice", flush=True)
        _mesh_engine_f32(host)
        _free()
        _mesh_serving_turns(host, card)
        _free()
        _mesh_train(host, card)
        _free()
        dist.destroy_process_group()
    print(f"mesh phase (5h): {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 5i


def _cross_mesh_pair(card):
    """(a) ``ServeEngine(mesh=d, prefill_mesh=p)`` on two distinct 1x1
    meshes over this rank: every admission takes the cross-mesh handoff
    (one broadcast over the ranks of both meshes, a group of one here).
    Full width in f32, 4 requests x 16 tokens: the colocated meshless
    engine's tokens before each request's first near-tie, handoffs above 0,
    #5 and #8 through the local route."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.config.registry import get_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.dispatch import LOCAL_MAP_CALLS, reset_local_map_calls
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine

    dev = torch.device("cuda")
    cfg = get_arch("smollm-135m").replace(dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    params["embed"]["table"] *= 10.0
    n, gen, prompt = FLEET_PAIR["requests"], FLEET_PAIR["gen"], SERVE["prompt"]
    tokens = make_token_stream(1, cfg.vocab_size, n, prompt)["tokens"]
    reqs = [Request(rid=i, tokens=tokens[i], max_new_tokens=gen) for i in range(n)]
    ecfg = EngineConfig(max_slots=n, max_seq=prompt + gen, max_new=gen, page_size=SERVE["page"], kv_layout="paged")

    def run(**kw):
        eng = ServeEngine(cfg, params, ecfg, **kw)
        comps = ContinuousScheduler(eng, clock=ManualClock()).run(reqs)
        return {c.rid: c.tokens for c in comps}, dict(eng.stats)

    want, _ = run()
    meshes = [DeviceMesh("cuda", torch.tensor([[0]]), mesh_dim_names=("data", "model")) for _ in range(2)]
    reset_launch_counts()
    reset_local_map_calls()
    got, stats = run(mesh=meshes[1], prefill_mesh=meshes[0])
    counts, route = launch_counts(), dict(LOCAL_MAP_CALLS)
    gates, margin = _cold_gates(params, cfg, reqs, want, where="cross-mesh pair f32")
    if not all(np.array_equal(got[i][: gates[i]], want[i][: gates[i]]) for i in range(n)):
        fail(f"cross-mesh pair f32: tokens {[got[i].tolist() for i in range(n)]} != colocated meshless engine "
             f"{[want[i].tolist() for i in range(n)]} (compared before positions {gates})")
    if stats["handoffs"] == 0:
        fail(f"cross-mesh pair f32: no handoff in {stats}")
    for name, key in (("flash_attention_fwd", "flash_attention"), ("flash_decode", "flash_decode")):
        if counts[name] == 0 or route[key] == 0:
            fail(f"cross-mesh pair f32: {name} launched {counts[name]} times, {route[key]} calls on the local route")
    equal = sum(int(np.array_equal(got[i], want[i])) for i in range(n))
    print(f"cross-mesh pair f32 (two 1x1 meshes, {card}): tokens equal to the colocated meshless engine's before "
          f"each first near-tie (compared {sum(gates.values())} of {n * gen} positions, smallest margin "
          f"{margin:.3e}; {equal}/{n} requests equal at every position); {stats['handoffs']} handoffs, "
          f"{stats['prefill_dispatches']} prefills; launches {json.dumps({k: counts[k] for k in ATTN_KERNELS})}, "
          f"local_map calls {json.dumps(route)}", flush=True)
    del params


def _fleet_world_of_one(card):
    """(b) ``launch.serve --mesh multipod --replicas 1`` and ``--disagg``
    in bf16 on a world of one: the replicas and the pair colocate meshless;
    every request returns its tokens, multipod serves on 2 replicas."""
    import torch

    from repro_torch.launch import serve

    base = [*SERVE_ARGV[: SERVE_ARGV.index("--requests")], "--requests", str(FLEET_LAUNCH["requests"]),
            "--prompt-len", str(FLEET_LAUNCH["prompt"]), "--gen", str(FLEET_LAUNCH["gen"]),
            "--max-slots", str(SERVE["slots"]), "--page-size", str(SERVE["page"]), "--device", "cuda"]
    for flags, replicas in ((["--mesh", "multipod", "--replicas", "1"], 2), (["--disagg"], 1)):
        result = serve.main(base + flags)
        torch.cuda.synchronize()
        comps = result["completions"]
        where = f"fleet launcher bf16 {' '.join(flags)}"
        if len(comps) != FLEET_LAUNCH["requests"] or any(len(c.tokens) != FLEET_LAUNCH["gen"] for c in comps):
            fail(f"{where}: expected {FLEET_LAUNCH['requests']} completions of {FLEET_LAUNCH['gen']} tokens")
        if len(result["replicas"]) != replicas or min(r["admitted"] for r in result["replicas"]) == 0:
            fail(f"{where}: replicas {result['replicas']}, want {replicas} that each admit")
        print(f"{where} ({card}): {json.dumps(_serve_summary(result))}; per replica (admitted, prefills, handoffs) "
              f"{[(r['admitted'], r['prefill_dispatches'], r['handoffs']) for r in result['replicas']]}", flush=True)


def _coboost_on_mesh(host, card):
    """(c) Co-Boosting on phase 4's market under the 1x1 mesh, the grouped
    bank's client axis split as it always is under a mesh: #1–#4 through
    the local route as often as meshless, the ensembling weights, server and
    generator within 1e-6 / 1e-5 of the meshless run on the same seed, both
    runs on cuDNN's deterministic algorithms (a second meshless run, timed
    after the sharded one, must give the first one's bits)."""
    from functools import partial

    import torch

    from repro_torch.core.coboosting import default_image_setup, run_coboosting
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.dispatch import LOCAL_MAP_CALLS, reset_local_map_calls
    from repro_torch.launch import ofl
    from repro_torch.models.cnn import cnn_apply, init_cnn
    from repro_torch.sharding import mesh_context
    from repro_torch.utils.device import disable_tf32
    from repro_torch.utils.prng import Draws
    from repro_torch.utils.trees import tree_leaves

    dev = torch.device("cuda")
    disable_tf32()
    args = ofl.parse_args(OFL_ARGV[: OFL_ARGV.index("--epochs")] + ["--epochs", str(MESH_COBOOST["epochs"])]
                          + OFL_ARGV[OFL_ARGV.index("--epochs") + 2 :])
    run = ofl.prepare_run(args, dev)

    def coboost(mesh):
        g = torch.Generator(device=dev).manual_seed(args.seed + 77)
        server = init_cnn(g, args.server_arch, args.classes, run.image_shape)
        g.manual_seed(args.seed + 5)
        gen_apply, gen = default_image_setup(g, run.cfg, args.classes, run.image_shape)
        reset_launch_counts()
        reset_local_map_calls()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mesh_context(mesh):
            st = run_coboosting(run.applies, run.params, partial(cnn_apply, args.server_arch), server,
                                gen_apply, gen, run.cfg, args.classes, Draws(args.seed, dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return st, wall / args.epochs, {n: launch_counts()[n] for n in LOSS_KERNELS}, dict(LOCAL_MAP_CALLS)

    # cuDNN's deterministic algorithms for both runs, so that the gates
    # see the route and not the convolutions' run-to-run spread, which the
    # chaotic f32 epoch amplifies (0.03 of a server parameter after 2
    # epochs without them, NVIDIA H100 80GB HBM3)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, _, plain_counts, _ = coboost(None)  # the reference, and the warm-up
        sharded, sharded_s, counts, route = coboost(host)
        again, plain_s, _, _ = coboost(None)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if not torch.equal(again.weights, plain.weights) or any(
            not torch.equal(a, b) for a, b in zip(tree_leaves(again.server_params), tree_leaves(plain.server_params))):
        fail("Co-Boosting meshless: two runs on the same seed differ with cuDNN's deterministic algorithms")
    if counts != plain_counts or min(counts.values()) == 0:
        fail(f"Co-Boosting on the mesh: loss-kernel launches {counts}, meshless {plain_counts}")
    if route["ensemble_kl"] != counts["ensemble_kl_fwd"] or route["ghm_ce"] != counts["ghm_ce_fwd"] \
            or route["client_bank"] == 0:
        fail(f"Co-Boosting on the mesh: local_map calls {route} against launches {counts}")
    gaps = {
        "w": float((sharded.weights - plain.weights).abs().max()),
        "server": max(float((a - b).abs().max()) for a, b in zip(tree_leaves(sharded.server_params),
                                                                  tree_leaves(plain.server_params))),
        "generator": max(float((a - b).abs().max()) for a, b in zip(tree_leaves(sharded.gen_params),
                                                                    tree_leaves(plain.gen_params))),
    }
    print(f"Co-Boosting on the 1x1 mesh, phase 4's market, {args.epochs} epochs, cuDNN deterministic ({card}): "
          f"s/epoch {sharded_s:.4f} (meshless {plain_s:.4f}); largest gaps to the meshless run {json.dumps(gaps)}; launches "
          f"{json.dumps(counts)}; local_map calls {json.dumps(route)}", flush=True)
    if gaps["w"] > 1e-6 or gaps["server"] > 1e-5 or gaps["generator"] > 1e-5:
        fail(f"Co-Boosting on the mesh: gaps {gaps} beyond 1e-6 (w) / 1e-5 (server, generator)")
    return counts, route


def fleet_path(card):
    """Phase 5i: the sharded fleet's pieces that one card can run, as a
    world of one."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if init_distributed("cuda", init_method=f"file://{tmp}/rendezvous") != 1:
            fail("fleet phase: expected a world of one")
        _cross_mesh_pair(card)
        _free()
        _fleet_world_of_one(card)
        _free()
        counts, route = _coboost_on_mesh(make_host_mesh("cuda"), card)
        _free()
        dist.destroy_process_group()
    print(f"fleet phase (5i): {time.perf_counter() - t0:.1f} s", flush=True)
    return counts, route


def _telemetry_flags(tmp, stem, profile=True):
    flags = ["--metrics-out", f"{tmp}/{stem}.jsonl", "--trace-out", f"{tmp}/{stem}.json"]
    return flags + (["--profile-dir", f"{tmp}/{stem}_prof"] if profile else [])


def _epoch_seconds(trace_path):
    """The ``ofl.epoch`` spans' host seconds, in epoch order."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["args"]["epoch"], e["dur"]) for e in events if e["name"] == "ofl.epoch")
    return [dur / 1e6 for _, dur in spans]


def _ofl_telemetry(tmp, coboost_counts):
    """Co-Boosting through ``launch.ofl`` with the telemetry flags: first
    metrics and spans alone (for the unprofiled s/epoch), then with the
    profiler too, each run's launches counted from 0."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import ofl
    from repro_torch.obs.phases import OFL_OUTER, OFL_PHASES, device_split
    from repro_torch.obs.tracer import PROFILE_TRACE
    from repro_torch.obs.validate import REQUIRED_OFL_KEYS, validate_metrics, validate_trace

    seconds = {}
    for stem, profile in (("ofl_unprofiled", False), ("ofl", True)):
        reset_launch_counts()
        ofl.main(["--method", "coboosting", *OFL_ARGV, *_telemetry_flags(tmp, stem, profile)])
        counts = {n: launch_counts()[n] for n in LOSS_KERNELS}
        if counts != coboost_counts:
            fail(f"telemetry ({stem}): loss kernel launches {counts} != phase 4's {coboost_counts}")
        records = validate_metrics(f"{tmp}/{stem}.jsonl", REQUIRED_OFL_KEYS)
        validate_trace(f"{tmp}/{stem}.json")
        seconds[stem] = _epoch_seconds(f"{tmp}/{stem}.json")
    epochs = int(OFL_ARGV[OFL_ARGV.index("--epochs") + 1])
    gen_iters = int(OFL_ARGV[OFL_ARGV.index("--gen-iters") + 1])
    ring = 4  # launch.ofl's buffer_batches
    want = {
        "ofl.epoch.count": epochs, "ofl.epoch.dispatches": epochs, "ofl.gen.steps": epochs * gen_iters,
        "ofl.ee.steps": epochs, "ofl.kd.steps": sum(min(e + 1, ring) for e in range(epochs)),
    }
    got = {r["name"]: r["value"] for r in records if r["type"] == "counter"}
    hist = {r["name"]: r["count"] for r in records if r["type"] == "histogram"}
    if got != want or hist != {"ofl.epoch.step_s": epochs}:
        fail(f"telemetry: ofl counters {got} and histograms {hist}, expected {want} and {epochs} epoch times")
    print(f"telemetry, Co-Boosting: counters {json.dumps(got)}; launches as phase 4 {json.dumps(coboost_counts)}",
          flush=True)
    unprof, prof = seconds["ofl_unprofiled"][1:], seconds["ofl"][1:]
    print(f"telemetry, Co-Boosting s/epoch after the first (ofl.epoch spans): unprofiled "
          f"{json.dumps(seconds['ofl_unprofiled'])} mean {sum(unprof) / len(unprof):.4f}, profiled "
          f"{json.dumps(seconds['ofl'])} mean {sum(prof) / len(prof):.4f}, ratio "
          f"{sum(prof) / sum(unprof):.3f}", flush=True)

    t0 = time.perf_counter()
    split = device_split(f"{tmp}/ofl_prof/{PROFILE_TRACE}")
    outer = split["outer"]
    if outer["count"] != epochs or outer["device_ms"] <= 0:
        fail(f"telemetry: the profile holds {outer['count']} {OFL_OUTER} ranges with {outer['device_ms']} device ms")
    per_epoch = {n: r["device_ms"] / epochs for n, r in split["ranges"].items()}
    covered = sum(r["device_ms"] for r in split["ranges"].values()) / outer["device_ms"]
    print(f"per-phase device ms an epoch (launches attributed by correlation; {split['device_ms']:.3f} device ms in "
          f"the whole profile, {outer['device_ms'] / epochs:.3f} an epoch inside {OFL_OUTER}): "
          + json.dumps({n: {"device_ms": per_epoch[n], "share": split["ranges"][n]["device_ms"] / outer["device_ms"],
                            "launches": split["ranges"][n]["launches"]} for n in OFL_PHASES})
          + f"; phases cover {covered:.4f}; unattributed {json.dumps(split['unattributed'])} "
          f"(read in {time.perf_counter() - t0:.1f} s)", flush=True)
    for name in OFL_PHASES:
        top = [[k[:70], round(ms / epochs, 3), n] for k, ms, n in split["ranges"][name]["top"]]
        print(f"  {name}, largest kernels, device ms an epoch: {json.dumps(top)}", flush=True)
    if covered < PHASE_COVERAGE:
        fail(f"telemetry: the three phases cover {covered:.4f} of the epoch's device time, below {PHASE_COVERAGE}")


def _serving_telemetry(tmp, serve_counts, serve_stats):
    """Serving through ``launch.serve``: tok/s with telemetry off and on (no
    profiler) in turns, then the run with all three flags, its launches
    counted from 0."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.obs.names import REQUEST_HISTOGRAMS
    from repro_torch.obs.validate import validate_metrics, validate_trace

    tok_s = {"off": [], "on": []}
    for turn, side in enumerate(SERVE_TURNS):
        flags = _telemetry_flags(tmp, f"serve_turn{turn}", profile=False) if side == "on" else []
        tok_s[side].append(serve.main(SERVE_ARGV + flags)["tok_per_s"])
    print(f"telemetry, serving tok/s in turns {','.join(SERVE_TURNS)}: off {json.dumps(tok_s['off'])}, "
          f"on {json.dumps(tok_s['on'])}", flush=True)

    reset_launch_counts()
    result = serve.main(SERVE_ARGV + _telemetry_flags(tmp, "serve"))
    counts = {n: launch_counts()[n] for n in ATTN_KERNELS}
    if counts != serve_counts:
        fail(f"telemetry, serving: attention launches {counts} != phase 5's {serve_counts}")
    records = validate_metrics(f"{tmp}/serve.jsonl")
    validate_trace(f"{tmp}/serve.json")
    st = result["stats"]
    if st["host_syncs"] != st["decode_chunks"] or (st["host_syncs"], st["decode_chunks"]) != (
        serve_stats["host_syncs"], serve_stats["decode_chunks"]
    ):
        fail(f"telemetry, serving: host_syncs {st['host_syncs']}, decode_chunks {st['decode_chunks']}; "
             f"phase 5: {serve_stats['host_syncs']}, {serve_stats['decode_chunks']}")
    value = {r["name"]: r.get("value", r.get("count")) for r in records}
    if (value["serve.decode.host_syncs"], value["serve.decode.chunks"]) != (st["host_syncs"], st["decode_chunks"]):
        fail(f"telemetry, serving: the metrics file disagrees with the engine's stats {dict(st)}")
    for name in REQUEST_HISTOGRAMS:
        if value.get(name) != SERVE["requests"]:
            fail(f"telemetry, serving: {name} has {value.get(name)} observations, expected {SERVE['requests']}")
    print(f"telemetry, serving: host_syncs {st['host_syncs']} == decode_chunks {st['decode_chunks']} (phase 5 "
          f"the same); {SERVE['requests']} observations in each request histogram; launches as phase 5 "
          f"{json.dumps(counts)}; profiled run {result['tok_per_s']:.1f} tok/s", flush=True)


def telemetry_path(coboost_counts, serve_counts, serve_stats):
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        _ofl_telemetry(tmp, coboost_counts)
        _serving_telemetry(tmp, serve_counts, serve_stats)


# ---------------------------------------------------------------------------
# phases 6 and 7


def lm_training_path():
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch, register_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    # one step at full width (f32 params), with f32 and then bf16 activations:
    # kernel gradients against plain autograd
    cfg = get_arch("smollm-135m")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(5))
    batch = {n: torch.as_tensor(a, device=dev) for n, a in make_token_stream(5, cfg.vocab_size, 2, TRAIN["seq"]).items()}
    def gaps(got, want):
        """Each leaf's largest gap relative to its largest gradient:
        ``(largest over leaves, its leaf, median over leaves)``."""
        rel = {n: float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30) for n, w in want.items()}
        worst = max(rel, key=rel.get)
        return rel[worst], worst, float(np.median(list(rel.values())))

    plain, kernels = {}, {}
    for dtype in ("float32", "bfloat16"):
        reset_launch_counts()
        kernels[dtype], plain[dtype] = _lm_grads(cfg.replace(dtype=dtype), params, batch)
        got = kernels[dtype]
        _check_variants(f"{dtype} full-width step", launch_counts(), dtype)
        for name, g in got.items():
            if not bool(torch.isfinite(g).all()):
                fail(f"{dtype} full-width step: gradient {name} not finite")
        gap, leaf, median = gaps(got, plain[dtype])
        print(f"{dtype} full-width lm_loss step, kernels vs plain autograd: loss {float(got['loss']):.6f} (plain "
              f"{float(plain[dtype]['loss']):.6f}); largest gradient gap relative to the leaf's largest gradient "
              f"{gap:.3e} ({leaf}), median over leaves {median:.3e}", flush=True)
        if dtype == "float32" and gap > 1e-3:
            fail(f"f32 full-width step: gradient gap {gap:.3e} at {leaf} beyond 1e-3")
    gap, leaf, median = gaps(plain["bfloat16"], plain["float32"])
    print(f"yardstick, plain autograd in bf16 vs in f32 activations: largest gradient gap {gap:.3e} ({leaf}), "
          f"median over leaves {median:.3e}", flush=True)
    # the gate on the kernels' bf16 rounding (P and dS rounded to bf16 for
    # the tensor cores): no further from the f32 gradients than twice what
    # bf16 activations alone move them
    kgap, kleaf, kmedian = gaps(kernels["bfloat16"], plain["float32"])
    print(f"bf16 kernels vs plain autograd in f32 activations: largest gradient gap {kgap:.3e} ({kleaf}), median "
          f"over leaves {kmedian:.3e}; limit 2 x {gap:.3e}", flush=True)
    if kgap > 2 * gap:
        fail(f"bf16 full-width step: the kernels' gradient gap to f32 {kgap:.3e} at {kleaf} beyond 2 x {gap:.3e}")
    # nothing of the checks above may stay on the card: the run below resets
    # the peak once its params and optimizer state exist, and phase 6b holds
    # the dry-run's count to that peak
    del params, plain, kernels, got, batch
    gc.collect()

    argv = ["--arch", "smollm-135m", "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
            "--steps", str(TRAIN["steps"]), "--optimizer", "adamw", "--device", "cuda"]
    reset_launch_counts()
    t0 = time.perf_counter()
    result = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: launch_counts()[n] for n in TRAIN_KERNELS}
    _check_variants("LM training path", launch_counts(), "bfloat16")
    losses = result["losses"]
    summary = {k: result[k] for k in ("first10", "last10", "s_per_step", "tok_per_s", "max_memory_bytes", "params")}
    print(f"LM training path ({wall:.1f} s with set-up): {json.dumps(summary)}; launches {json.dumps(counts)}", flush=True)
    # remat: the forward twice a layer a step (its recompute in the backward pass), each backward pass once
    want_n = TRAIN["layers"] * TRAIN["steps"]
    for name, n in counts.items():
        want = 2 * want_n if name.startswith("flash_attention_fwd") else want_n
        if n != want:
            fail(f"LM training path launched {name} {n} times, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"LM training path: non-finite loss in {losses}")
    if not result["last10"] < result["first10"]:
        fail(f"LM training path: loss did not fall (first-10 {result['first10']:.4f}, last-10 {result['last10']:.4f})")
    print(f"LM training: {result['s_per_step']:.4f} s/step, {result['tok_per_s']:.1f} tokens/s after the first step, "
          f"max_memory_allocated {result['max_memory_bytes']} bytes, loss {np.mean(losses[:10]):.4f} -> "
          f"{np.mean(losses[-10:]):.4f}", flush=True)
    # the same run without remat, under its own name in this process: its
    # s/step and peak memory beside the run above (printed, not gated)
    plain = register_arch(get_arch("smollm-135m").replace(name="smollm-135m-no-remat", remat=False))
    other = train.main([a if a != "smollm-135m" else plain.name for a in argv])
    print(f"LM training without remat: {other['s_per_step']:.4f} s/step, {other['tok_per_s']:.1f} tokens/s after the "
          f"first step, max_memory_allocated {other['max_memory_bytes']} bytes (remat: {result['s_per_step']:.4f}, "
          f"{result['max_memory_bytes']}); losses equal to the remat run's: {other['losses'] == losses}", flush=True)
    return counts, result


def _dryrun_records(*runs):
    """The records of ``python -m repro_torch.launch.dryrun`` runs, one
    subprocess each (each builds a one-process fake world of 256 ranks),
    started together, and the seconds until the last ended."""
    import os

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = []
        for i, args in enumerate(runs):
            out = Path(tmp) / f"dryrun{i}.json"
            procs.append((args, out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", str(out)], cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=str(SRC)), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)))
        try:
            errs = [proc.communicate(timeout=300)[1] for _, _, proc in procs]
        finally:
            for _, _, proc in procs:
                proc.kill()  # a no-op for one that has ended
        seconds = time.perf_counter() - t0
        for (args, _, proc), err in zip(procs, errs):
            if proc.returncode:
                fail(f"dry-run {' '.join(args)} exited {proc.returncode}:\n{err[-4000:]}")
        return [json.loads(out.read_text()) for _, out, _ in procs], seconds


def dryrun_path(train_counts, train_result):
    """Phase 6b: the dry-run (``repro_torch.launch.dryrun``) on this machine,
    then held to phase 6's measured run."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import INPUT_SHAPES, ShapeConfig, TrainConfig, arch_supports_shape, get_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.launch.specs import build_program
    from repro_torch.models.transformer import init_lm
    from repro_torch.roofline import roofline_report
    from repro_torch.roofline.op_cost import count_step
    from repro_torch.runtime.steps import make_train_step

    # (a) smollm-135m at full width over the four shapes on the 16x16 mesh,
    # and the Co-Boosting distillation step at train_4k
    cfg = get_arch("smollm-135m")
    skip = arch_supports_shape(cfg, INPUT_SHAPES["long_500k"])
    (records, coboost), sec = _dryrun_records(
        ["--arch", "smollm-135m", "--multi-pod", "single"],
        ["--arch", "smollm-135m", "--multi-pod", "single", "--coboost", "4", "--shape", "train_4k"])
    for r in records + coboost:
        want = ("skip", skip) if r["shape"] == "long_500k" else ("ok", None)
        if (r["status"], r.get("reason")) != want:
            fail(f"dry-run {r['arch']} {r['shape']} {r['mesh']}: {r['status']} {r.get('reason') or r.get('error')}, "
                 f"expected {want}")
    for r in records + coboost:
        if r["status"] == "ok":
            print(f"dry-run {r['arch']} {r['shape']} {r['mesh']}{' coboost 4' if 'coboost_clients' in r else ''}: "
                  + json.dumps({k: r[k] for k in ("compute_s", "memory_s", "collective_s", "dominant", "bound_s",
                                                  "peak_bytes_per_device", "fits_hbm", "useful_flops_ratio",
                                                  "mfu_bound", "count_s")}), flush=True)
    print(f"dry-run (a): {len(records)} records and coboost 4 in {sec:.1f} s (two processes at once)", flush=True)

    # (b) phase 6's program counted meshless: smollm-135m at full width, bf16,
    # AdamW, remat, 8 x 256; held to phase 6's run
    shape = ShapeConfig("phase 6", TRAIN["seq"], TRAIN["batch"], "train")
    tc = TrainConfig(optimizer="adamw", learning_rate=3e-3, schedule="linear_warmup_cosine", warmup_steps=1,
                     total_steps=TRAIN["steps"])
    t0 = time.perf_counter()
    counts = count_step(*build_program(cfg, shape, tc))
    rec = roofline_report(counts, 1, cfg, shape)
    count_s = time.perf_counter() - t0
    per_step = {n: train_counts[n] / TRAIN["steps"] for n in TRAIN_KERNELS}
    calls = {n: rec["kernels"].get(n, {}).get("calls", 0) for n in TRAIN_KERNELS}
    if calls != per_step:
        fail(f"dry-run kernel calls a step {calls}, phase 6 launched {per_step} a step")
    # the same step really run once on the card under FlopCounterMode
    dev = torch.device("cuda")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(cfg, tc)
    opt_state = step.optimizer.init(params)
    batch = {n: torch.as_tensor(a, device=dev)
             for n, a in make_token_stream(0, cfg.vocab_size, TRAIN["batch"], TRAIN["seq"]).items()}
    with FlopCounterMode(display=False) as flop_counter:
        step(params, opt_state, batch, 0)
    torch.cuda.synchronize()
    real = flop_counter.get_total_flops()
    del params, opt_state
    aten = rec["aten_flops_per_device"]
    if aten != real:
        fail(f"dry-run aten FLOPs {aten} != FlopCounterMode's {real} on one real step")
    ratio = rec["bound_s"] / train_result["s_per_step"]
    peak = rec["peak_bytes_per_device"] / train_result["max_memory_bytes"]
    print(f"dry-run (b), phase 6's program meshless ({count_s:.1f} s): " + json.dumps(
        {k: rec[k] for k in ("flops_per_device", "aten_flops_per_device", "bytes_per_device", "compute_s",
                             "memory_s", "dominant", "bound_s", "argument_bytes_per_device",
                             "temp_bytes_per_device", "peak_bytes_per_device")})
          + f"; kernel calls a step {json.dumps(calls)} (phase 6: the same); aten FLOPs equal FlopCounterMode's "
          f"({real}); bound / measured s/step {rec['bound_s']:.6f} / {train_result['s_per_step']:.6f} = {ratio:.4f};"
          f" peak / max_memory_allocated {rec['peak_bytes_per_device']} / {train_result['max_memory_bytes']} = "
          f"{peak:.4f}", flush=True)
    if ratio > 1:
        fail(f"dry-run bound {rec['bound_s']} s above phase 6's measured {train_result['s_per_step']} s/step")
    if not 0.9 <= peak <= 1.1:
        fail(f"dry-run peak {rec['peak_bytes_per_device']} bytes is {peak:.3f} x phase 6's max_memory_allocated")


def lm_distill_path():
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import distill_llm

    reset_launch_counts()
    t0 = time.perf_counter()
    result = distill_llm.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: launch_counts()[n] for n in TRAIN_KERNELS}
    _check_variants("LM distillation path", launch_counts(), "bfloat16")
    print(f"LM distillation path ({wall:.1f} s with set-up): kd {result['kd']}, final w {result['w'][-1]}; "
          f"launches {json.dumps(counts)}", flush=True)
    if len(result["kd"]) != 8 or not all(math.isfinite(x) for x in result["kd"]):
        fail(f"LM distillation path: kd not finite at every epoch: {result['kd']}")
    for w in result["w"]:
        if abs(sum(w) - 1.0) > 1e-5:
            fail(f"LM distillation path: w {w} does not sum to 1")
    for name, n in counts.items():
        if n == 0:
            fail(f"LM distillation path never launched {name}")


def main() -> None:
    import torch

    seconds = {}

    def phase(name, fn, *args):
        """Run one phase, keeping its seconds for the summary line."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    card = phase("1", environment)
    errs, timing = phase("2 loss", kernels_vs_plain)
    attn_errs, attn_timing = phase("2 attention", attention_kernels_vs_plain)
    errs.update(attn_errs)
    timing.update(attn_timing)
    bwd_errs, bwd_timing = phase("2 attention bwd", attention_bwd_kernels_vs_plain)
    errs.update(bwd_errs)
    timing.update(bwd_timing)
    phase("3", small_input_agreement)
    phase("3 lm", lm_small_input_agreement)
    counts, coboost = phase("4", main_path)
    phase("4b", baselines_path, coboost)
    phase("4c", bank_path, {n: counts[n] for n in LOSS_KERNELS})
    phase("5 f32", serving_parity_f32)
    serving, serve_stats = phase("5", serving_path)
    phase("5c f32", prefix_spec_f32)
    phase("5c", prefix_spec_path)
    granite = phase("5d", rest_of_serving_path, card)
    phase("5e", moe_qk_norm_path, card)
    phase("5f", recurrent_path, card)
    phase("5g", modality_path, card)
    phase("5h", mesh_path, card)
    mesh_counts, mesh_route = phase("5i", fleet_path, card)
    phase("5b", telemetry_path, {n: counts[n] for n in LOSS_KERNELS}, serving, serve_stats)
    counts.update(serving)
    train_counts, train_result = phase("6", lm_training_path)
    counts.update(train_counts)
    print(f"flash_attention_fwd launches: serving path {serving['flash_attention_fwd']} (tensor cores "
          f"{serving['flash_attention_fwd_sm90']}), granite-3-2b serving {granite['flash_attention_fwd']}, LM training path {counts['flash_attention_fwd']} (tensor cores "
          f"{counts['flash_attention_fwd_sm90']}; the table's)", flush=True)
    phase("6b", dryrun_path, train_counts, train_result)
    phase("7", lm_distill_path)
    print(f"phase seconds: {json.dumps(seconds)}; total {sum(seconds.values()):.1f}", flush=True)
    print("kernels: " + json.dumps({
        n: {"launches": counts[n], "max_abs_err": errs[n],
            **({"launches_on_the_mesh": mesh_counts[n]} if n in mesh_counts else {})}
        for n in REPLACES
    }) + f"; phase 5i local_map calls {json.dumps(mesh_route)}")
    table = [
        {
            "name": n, "route": ROUTES[n], "source": SOURCES[n], "replaces": REPLACES[n],
            "launches": counts[n], "max_abs_err": errs[n], "library_ms": None, **timing[n],
        }
        for n in REPLACES
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
