#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and ``nvcc``;
builds every kernel from ``deepspeed_tpu_torch/csrc``, one ``nvcc`` per
source, all started together.  Phases:

  1. environment: card name and power limit, versions, kernel build time,
     and ptxas's registers of the bf16 K6b/K6c and K1/K2a/K2b
     instantiations (a spill fails the run);
  2. K3 paged attention against its plain PyTorch version at the serving
     shapes of Llama-3-8B (H=32, n_kv=8, D=128, page 16, bf16): decode,
     decode with every context at 2000 keys (both split over the context),
     a prefill chunk, a mixed step with padding rows and null pages, and the
     speculative verify shape (8 rows of C = 5 at contexts 64-1024) —
     error, kernel / plain / library (SDPA) time and the roofline bound;
     float32 decode (the scalar kernel), forced empty splits, rep 1 at head
     dim 64, one tensor-core product against torch.matmul, the merge
     kernel against its plain version, faulty kernels the check must
     reject, and the decode time by split count; then the zoo's rows: head
     dims 80 and 96 at Llama-3-8B's decode and prefill shapes, Falcon-7B's 71
     heads on one kv head at decode and a 256-token chunk, a window of 4096
     over 6000-key contexts at decode and prefill, alibi at 32 heads of 64,
     Qwen1.5-MoE's 16 heads on 16 kv heads of 128 at decode and prefill,
     a tensor-2 rank's heads of Llama-3-8B (16:4) and Qwen1.5-MoE (8:8),
     and of Phi-2 (16:16, D 80), OPT-6.7B (16:16, D 128) and Falcon-RW-1B
     (16:16, D 64, alibi with the second rank's slopes) at phase 27's
     decode batch and a chunk — each timed beside its
     bound, plain and SDPA (same mask or bias) — and in float32, with five
     faulty kernels of those routes rejected;
  3. serving: ``build_engine`` → ``put`` / ``step`` on Llama-3-8B at full
     width and depth with seeded random weights, continuous batching of 8
     requests with SplitFuse chunking, fused decode and a prefix-cache hit,
     each step a replay of a CUDA graph captured at its key's first
     dispatch; asserts token counts, page accounting, that every layer of
     every forward launched K3 and that decode took its split route;
  4. path parity: the kernel path against the plain path — identical greedy
     streams in float32 (2 layers, full width), and close first-step logits
     in bf16 at full depth;
  5. K1/K2a/K2b flash attention against their plain versions at the
     training shapes of Llama-125M (B 24, S 1024, 12 heads of 64) and of
     Llama-3-8B (B 1, S 4096, 32/8 heads of 128), bf16 and f32, causal and
     full, with a query offset and with Sk > Sq — error, kernel / plain /
     library (SDPA forward, SDPA backward) time and the roofline bound;
     K2a and K2b launched twice on each case give bit-identical dq, delta,
     dk and dv; two bf16 GQA cases whose blocks hold rows that are not
     valid (rep 3, and an Sq tail with a query offset); then the zoo's
     training shapes (B 2, S 2048): Phi-2's head dim 80 and Phi-3-mini's
     96 (32 heads on 32), and Falcon-7B's 71 query heads of 64 on one kv
     head (the wrappers' repeated-KV route), causal in bf16 and float32,
     each timed beside its bound, plain and SDPA, and in bf16 with a query
     offset; and a tensor-2 rank's 16 heads of Phi-2 (D 80) in bf16;
  6. training: ``initialize`` → ``train_batch`` on Llama-125M at the JAX
     package's bench configuration (B 24, S 1024, bf16, AdamW, ZeRO-2,
     remat ``flash_saveable``), full width and depth with seeded random
     weights — tokens/s, step time, MFU, peak memory, losses falling on a
     repeated batch, K1/K2a/K2b launches per step (one per layer each), and
     a profiled step;
  7. training parity, kernel path (``attention_impl="flash"``) against the
     plain path (``"chunked"``): 3 float32 AdamW steps at 125M width, and 3
     bf16 steps at Llama-3-8B width (2 layers, S 2048) held against a
     float32 run;
  8. K6a/K6b/K6c block-sparse attention against their plain versions at
     BERT-large's attention (B 4, 16 heads of 64, S 4096, block 16, bf16)
     for seven layouts (DeepSpeed's documented fixed example, fixed
     unidirectional, BigBird, BSLongformer, variable, local window, dense),
     with faulty kernels the check must reject, a key padding mask (and one
     that leaves rows with no visible key: o exactly 0, lse 3e38), float32
     at S 1024, head dim 128 at blocks 32, 64 and 128; kernel / plain /
     library (SDPA with the layout as a token mask) time and the roofline
     bound for the fixed example and BigBird, and a layout with global
     blocks against a local one of the same density (the straggler's
     share); the documented example's row and column groups (the CTAs of
     the bf16 K6b and K6c), K6b and K6c launched twice on every case with
     bit-identical dq, delta, dk and dv, and a K6c that loses one group
     member's dk among the faulty kernels;
  9. the sparse path through its entry points: ``DeepSpeedConfig`` with the
     documented ``sparse_attention`` block → ``make_sparsity_config`` →
     ``SparseSelfAttention`` forward and backward on CUDA tensors, three
     iterations — K6a/K6b/K6c launches per call, finite gradients, outputs
     against the plain versions, peak memory, and each kernel's device time
     inside the path (CUDA events around its launch);
 10. K4a/K4b/K5a/K5b block quantization against their plain versions at
     the qgZ wire's shapes (the 24,576,000-element embedding of Llama-125M
     in f32 and bf16, a padded norm weight, 1001 blocks, the embedding as a
     view one element into its storage, blocks of 64), codes, scales and
     dequantized values identical and K5a on the route each case should
     take (``q4_kernel_256``, or ``q4_kernel_any`` for the view and block
     64), with three faulty kernels the check must reject; kernel / plain
     time and the bound, K5a's also on bf16 input and on the misaligned
     view; then the grouped K4a/K4b on
     one qgZ step's real table (the 111 gradients of Llama-125M at W 2, bf16
     input): the send buffer, the received copies, the shards and the
     gathered tensors identical to the plain versions, two faulty grouped
     kernels rejected, per-step device ms beside the per-step bound;
 11. data-parallel training through the entry points: two spawned ranks on
     the one card over gloo (NCCL takes one card per rank), each
     ``initialize`` → ``train_batch`` on Llama-125M at full width and depth
     with ``zero_quantized_gradients`` (12 of the 24 rows per rank) —
     K4a/K4b launches (2 each per step, the grouped exchange), 4 wire
     collectives per step, K1/K2 once per layer, step and wire time,
     tokens/s, peak memory, bit-identical ranks, the CommsLogger's bytes,
     one step's real gradients through the grouped exchange equal to the
     per-tensor route bit for bit, the codec's ms per step with host issue
     included on both routes; then LoCo (K4b 3 per step), a float32-wire
     control and the int4 collectives (K5a/K5b, K5a on ``q4_kernel_256``)
     against their plain versions;
 12. the serving stack above the engine (run after phase 4, on phase 3's
     weights): ``ServingEngine`` on a wall clock over ``build_engine`` with
     a ``TieredKVManager``, 16 open-loop requests (prompts 64-1024, two
     pairs sharing a 512-token prefix, 32-64 new tokens, two priority
     classes) into a device arena of ~40% of the mix's pages, so KV
     pressure preempts by demoting to the host tier — TTFT and TPOT p50/p99,
     goodput, decode tok/s, preemptions, demotions and promotions, staged
     bytes and the d2h/h2d GB/s of ``export_pages``/``import_pages``, wall
     and peak memory; every request done with its tokens, every promoted
     block re-exported equal to the bytes imported and among the demoted
     snapshots', pages and host tier accounted for, K3 launches == layers x
     forwards; then one request migrated out after 8 tokens and resubmitted
     with its snapshot, its tokens equal to the bare engine's;
 13. the step set as CUDA graphs, and speculative decoding (run after phase
     12, on phase 3's weights): ``warm_all`` captures the six keys of a
     spec engine (decode, the 256-token chunk, the fused rungs of 2, 4 and
     8 rounds, the verify of 5 positions), each key's replay against its
     eager step on a real packed batch (tokens and KV arena bit for bit),
     K3's kernels inside a profiled replay, the fused rung's wall ms per
     round and device busy share eager and as a graph on the same batch;
     phase 3's greedy mix plus two prompts that repeat a pattern served
     with and without speculation (verify rounds, acceptance, rollback
     pages, pages accounted); then float32 at phase 4's setting, where the
     spec and plain streams must be equal but for reported rounding ties;
 14. the serving fleet (run after phase 13, on phase 3's weights): three
     replicas of one engine factory sharing the weights on the card, a
     ``PrefixDirectory`` and its routing policy, ``warm_all`` on each, then
     ``FleetSimulator`` on a wall clock over 24 Poisson requests (8/s, three
     512-token prefix groups, 32-64 new tokens) with the last replica
     killed at 1.0 s and recovered at 2.5 s — TTFT/TPOT p50/p99, goodput,
     e2e p50, round and tick ms, the recovery split into build, ``warm_all``
     and probe, affinity hits and prefix imports, each engine's forwards
     and K3 launches, memory before and after the kill and after the
     recovery; every request done with its tokens, one kill that requeued
     work, the recovered replica healthy and serving, no tick error, pages
     accounted, K3 == layers x the forwards of every engine made (the
     killed one included), the dead engine collected and its arena
     returned; a profiled decode round's busy share; then the JAX fleet
     test's kill mid-decode in float32 at phase 4's setting, its streams
     equal to ``generate`` but for rounding ties, twice with equal
     summaries;
 15. training features (run after phase 7, on fresh Llama-125M trainers
     built as phase 6's): ``initialize(training_data=)`` and
     ``train_batch(data_iter=...)`` over a seeded token dataset (batches in
     the loader's order), 4 steps with a synchronous ``save_checkpoint``
     after step 2 and an async one after step 3 (state bytes, save s split
     into state, manifest and publish, GB/s), a control run of two fresh
     engines, a resume from step 2 equal to the uninterrupted run by the
     control's criterion (bit for bit if the control is), the async tag
     against a host copy taken at its save, the fallback from a corrupt
     ``latest`` (``resilience/ckpt_fallback``), LAMB/Lion/Adagrad/SGD 3
     steps each (step ms, the optimizer step's device ms, losses falling),
     progressive layer drop (theta and mask per step), the synchronized
     ``train_batch`` timer and the CSV monitor's files; K1/K2a/K2b once per
     layer per step throughout;
 16. Falcon-7B at full width and depth (run after phase 14's weights are
     dropped): the published ``tiiuae/falcon-7b`` config in code, seeded
     bf16 weights made on the card under HF's names and converted in memory
     by ``FalconPolicy``; phase 3's mix and checks (K3 == 32 x forwards), a
     profiled decode round (K3's device ms), phase 4's bf16 logits parity,
     and a short bf16 greedy run equal on the kernel and plain paths but
     for rounding ties;
 17. the zoo through ``build_hf_engine`` from a directory: OPT-6.7B
     (``pytorch_model.bin``), Phi-2 (head dim 80), Phi-3-mini-4k (96, fused
     projections), Mistral-7B-v0.1 (window 4096, one 4608-token request),
     Qwen2-7B (q/k/v biases) and Falcon-RW-1B (alibi) — each written by this
     script (``model.safetensors`` by its own writer) at its published widths
     cut to ZOO_LAYERS layers; phase 3's mix and checks (K3 == layers x
     forwards), then float32 greedy streams identical on the kernel and
     plain paths; each directory removed after its model, but
     Falcon-RW-1B's and OPT-6.7B's, kept (with their one-card streams)
     for phase 27(a);
 18. Qwen1.5-MoE-A2.7B at full width and depth (after phase 17): the
     published ``Qwen/Qwen1.5-MoE-A2.7B`` config in code (60 experts, top-4,
     a shared expert, 16 heads of 128), 14.31 B seeded bf16 parameters made
     on the card under HF's names and converted in memory by
     ``Qwen2MoePolicy``; phase 3's mix and checks (K3 == 24 x forwards), a
     profiled decode round, bf16 greedy streams equal on the kernel and plain
     paths but for rounding ties, phase 4's logits parity with every routing
     flip between the two bf16 paths reported (layer, token, both routers'
     margins; each token's first flip within BF16_TIE_ULPS bf16 ulps, each
     later one within them or with its router input moved further than
     any not yet flipped token's), and the expert histogram per layer;
 19. Mixtral-8x7B through ``build_hf_engine`` from a directory: the
     published ``mistralai/Mixtral-8x7B-v0.1`` config cut to MIXTRAL_LAYERS
     of 32 layers, written as ``model.safetensors``, served dropless;
     phase 17's mix and checks, then float32 greedy streams identical on the
     kernel and plain paths;
 20. MoE training: ``initialize`` → ``train_batch`` on Mixtral-8x7B's widths
     at one layer (1.71 B parameters), B 2, S 1024, bf16, AdamW, remat,
     ``make_mixtral_loss_fn`` — step ms, tokens/s, K1/K2a/K2b once per layer
     per step, the dropped share of the router's choices and ``l_aux``; then
     3 float32 steps of a 2-layer Mixtral (hidden 1024, D 64, tokens dropped)
     on the kernel path against the plain path, within phase 7's
     tolerances;
 21. the v1 engine (after phase 19): GPT-NeoX at the published
     ``EleutherAI/pythia-6.9b`` config in code (32 layers, 32 heads of 128,
     13.7 GB of seeded bf16 weights) through ``init_inference`` with kernel
     injection, ``generate`` 64 tokens for 4 prompts of 448 in one [4, 512]
     buffer — K1 == 32 x forwards, ms a forward, tok/s; phase 4's bound on
     the bf16 logits against the plain path and float32; float32 greedy
     streams identical on both paths at 2 layers; GPT-J (head dim 256)
     refused by injection; phase 27(a)'s reference (the first row's
     logits, a short greedy buffer); then GPT-2 (124M) trained 5 steps through
     ``initialize`` with ``attention_impl="flash"`` (B 8, S 1024, bf16):
     K1/K2a/K2b 12 a step, losses finite;
 22. weight-only int8 serving (after phase 14, on phase 3's weights):
     ``quantize_inference_params`` on the card, phase 3's mix through
     ``InferenceEngineV2`` — K3 == 32 x forwards, K4b == the quantized
     tensors x forwards (a layer's weights dequantized to bf16 just before
     the layer), every step a CUDA graph, the resident bytes against bf16's,
     a profiled decode round (K4b's device ms); greedy streams equal to a
     bf16 engine's over the weights dequantized once but for rounding ties;
     K4b's block-128 bf16 store against its plain version, timed beside its
     bound;
 23. the v1 families through ``build_hf_engine`` from directories:
     bigscience/bloom-7b1, EleutherAI/pythia-6.9b, EleutherAI/gpt-j-6b,
     EleutherAI/gpt-neo-2.7B, bert-large-uncased and
     openai/clip-vit-large-patch14 at their published widths cut to
     V1_ZOO_LAYERS layers, seeded weights in the published dtype, each
     served by the float32 v1 route on the card and on the CPU: outputs
     within V1_F32_TOL (TF32 off), the causal models' greedy streams equal
     but for float32 ties; write and load seconds;
 24. training the dense zoo (after phase 20): Phi-2 at its published width
     and full depth (32 layers, head dim 80, 2.78 B parameters) through
     ``initialize`` → ``train_batch``, bf16, AdamW, remat ``flash_saveable``,
     B 2 of S 2048 — step ms, tokens/s, MFU, peak memory, K1/K2a/K2b once
     per layer per step; then Phi-3-mini-4k (head dim 96, its window
     dropped), Falcon-7B (71:1), Falcon-RW-1B (alibi: no kernel, as JAX),
     OPT-6.7B, Mistral-7B at S 8192 with its 4096 window (the chunked path,
     as JAX), Qwen2-7B and InternLM-7B at their published widths cut to
     ZOO_LAYERS layers: one float32 step on the kernel path against the
     plain path within phase 7's tolerances, three bf16 steps with finite
     losses, K1/K2a/K2b once per layer per step (0 where no kernel runs);
 25. ZeRO over several ranks on the one card (one spawn of four gloo
     ranks: stage 3 at W = 4, 6 rows a rank, held to W = 3's stage 0; then
     three of them form a new process group for stages 0, 1 and 2 at W = 3,
     8 rows a rank; at W = 3 stage 3's layout refuses the vocab of 32000):
     ``initialize`` →
     ``train_batch`` on Llama-125M at phase 6's configuration (bf16, AdamW,
     remat ``flash_saveable``, B 24 of S 1024), one warm-up and one timed
     step each — per stage and rank the losses,
     step ms, the comm layer's ms a step (each collective fenced by
     synchronizes), collectives a step by kind, state bytes (parameters,
     master, moments) against the reckoning of the partition, peak memory,
     K1/K2a/K2b launches a step (12 each); the ranks' gathered parameters
     bit-identical, losses within bf16's tolerance of stage 0's, stage 3's
     peak below stage 0's; both routes of gloo's reduce-scatter of CUDA
     tensors timed on the stage-2 gradient buffer (0.54 GB), agreeing; then
     float32 at 2 layers of 125M width in the same spawn, every stage
     against stage 0 (losses within rtol 1e-5, parameters within 1e-6 on
     all but 1e-3 of the entries).  Last at W = 4, expert parallelism as
     data 2 × expert 2: Mixtral-8x7B's widths at one layer (phase 20's),
     each rank building its 4 of 8 experts (``expert_parallel_size=2``),
     ZeRO-2, bf16, AdamW, one row of S 1024 a rank, one warm-up and one
     timed step — losses finite and falling, dense parameters bit-identical
     on every rank and each bank within its expert-data group, state bytes
     a rank against the reckoning, all-to-alls a step by kind (dispatch and
     combine, forward twice with the remat recompute, backward once),
     K1/K2a/K2b once a step, step and wire ms, every rank's peak; and the
     float32 losses of expert 2 against expert 1 at 2 narrow layers (rtol
     1e-5).  Then the same Mixtral run over expert 2 × tensor 2 (each rank
     its 4 experts at half of ``expert_mlp``, 16:4 heads, on the same 4
     rows, 2 a data rank): a rank's 504,410,112 parameters and its state
     bytes against the reckoning, K1/K2a/K2b once a step, one MoE all-reduce
     a layer's forward, the first loss within 2e-3 of data 2 × expert 2's,
     the replicated tensors bit-identical on every rank; and in float32 at
     the 2 narrow layers, in 2 micro-batches of one row a data rank (the
     gating groups of expert 2 × tensor 1), losses within 1e-6 of expert 2
     × tensor 1's, the router and norms bit-identical, the first step's
     ``exp_counts`` equal.  Then Phi-2's widths at 2 layers over data 2 ×
     tensor 2 (ZeRO-2, bf16, one step on phase 27(b)'s rows): a rank's
     209,784,320 parameters and its state bytes against the reckoning,
     K1/K2a/K2b once a layer on 16:16 heads, the first loss within 2e-3 of
     a data-4 engine's on the same rows, the replicated tensors
     bit-identical; ``partition_activations`` on one Phi-2 block at tensor
     2 (values and gradients equal to the unpartitioned checkpoint's, half
     its saved bytes, one gather in the recompute); and in float32 at 2
     narrow layers Falcon-RW (alibi), Falcon's parallel block, OPT and Phi
     at tensor 2 within 1e-6 of tensor 1, replicated tensors bit-identical.
 26. offload, after phase 24 (phase 1 prints the host's ``MemTotal`` and
     ``MemAvailable``): Phi-2 as phase 24 trains it but at 4 of its 32
     blocks (widths kept, for the script's time), first without offload
     (two steps: the reference), then with the host-optimizer tier
     (``offload_optimizer: {device: cpu}``: float32 master and moments in
     pinned host memory, Adam on the host CPU; one step, then the updated
     weights' loss by ``eval_batch``) and the host-streamed tier
     (``pipeline_read``, 10 groups, two staged at once on the card; a warm,
     a flushed timed and a serialized probe step) — step ms and its split
     (forward/backward, gradients device -> host, host Adam or the stream
     pipeline, parameters host -> device), tokens/s, peak device GB against
     the reference's, pinned host bytes against 12 B a parameter,
     K1/K2a/K2b once per layer per step (and per eval forward), the first
     two losses against the reference's; Llama-125M as phase 6 trains
     it with the NVMe tier (swap files in a temporary directory; bytes read
     and written a step against 12 B a parameter; a rebuilt engine resuming
     the swap files continues exactly), with ``offload_param`` at stage 3
     (host copies a step: 2 per block and one for the rest; peak below, and
     losses within bf16 of, the engine without offload),
     ``offload_states``/``reload_states`` (the device frees the state's
     bytes; it comes back bit for bit), and phase 15's step-2 checkpoint
     converted to universal atoms and loaded into a fresh ZeRO-2 engine,
     whose next loss equals the resumed engine's.
 27. tensor parallelism over gloo ranks sharing the card: (a) serving, on
     phase 11's two ranks after their training: each builds its slices of
     phase 3's Llama-3-8B (each tensor drawn whole from the same seeded
     generator, the rank's slice kept) and serves 4 of phase 3's requests
     (their prompts' first 128 tokens), 16 new tokens each, through
     ``InferenceEngineV2(tensor_parallel=2)`` (a batch of 4 rows; the steps run eagerly: a gloo collective cannot be
     captured) — every rank's tokens equal, each request's stream equal to
     phase 3's engine's (recorded there) up to its first difference, and
     that a bf16 rounding tie (``greedy_ties``'s rule on both paths' logits
     of the context before it: the step's own logits on the ranks, phase 3's
     logits of each stream position), the first-step logits held as phase 4 holds its kernel path (within 2·e of
     phase 3's engine's and 1.5·e of phase 4's float32 logits, e phase 4's
     plain path's bf16 rounding error), a rank's
     parameter bytes against the reckoning (4,015,263,744 of 8,030,261,248
     parameters), its arena half the single card's, K3 == layers x
     forwards on 16:4 heads, the collectives a forward (2 a layer, the
     embedding's, the logits gather), peak memory, prefill tok/s and a
     decode round's ms (gloo on one card: function, not speed); then float32
     at Llama-3-8B's widths cut to 2 layers: the greedy stream of phase 4's
     first prompt equal to its one-card stream, first-step logits within
     1e-4 of its largest.  Then Qwen1.5-MoE-A2.7B at full width and depth
     over tensor 2 on the same ranks, each drawing phase 18's seeded HF
     tensors one at a time and keeping its slices (never the whole model):
     a rank's 7,159,441,408 parameters of 14,315,784,192, its arena half of
     phase 18's, K3 == 24 × forwards on 8:8 heads, collectives a forward
     (the embedding's, o_proj's and the MoE layer's a layer, the logits
     gather), every rank's tokens equal, each stream equal to phase 18's
     one-card stream up to a bf16 tie, first-step logits within 2·e of
     phase 18's (e its plain path's bf16 rounding measure); float32 at 2
     layers, the whole seeded model through ``Qwen2MoePolicy.convert`` cut
     to the rank's slices by the engine (``_rank_state``): the stream of
     phase 4's first prompt equal to one card's.  Then Phi-2 at full width
     and depth (seeded under HF's names, each tensor cut as it is drawn):
     a rank's 1,390,008,320 of 2,779,683,840 parameters, its arena half one
     card's, K3 == 32 × forwards on 16:16 heads of 80, the collectives a
     forward (two row-parallel all-reduces a parallel block), the ranks'
     tokens equal, each stream the parent's one-card stream up to a bf16
     tie, first-step logits within 2·e; phase 17's Falcon-RW-1B (alibi) and
     OPT-6.7B directories through ``build_hf_engine`` at tensor 2, each
     held to phase 17's bf16 streams up to a tie and its float32 streams
     exactly; Falcon-7B at tensor 2 refused with JAX's error; and the v1
     engine: pythia-6.9b (phase 21's weights) through
     ``init_inference(tensor_parallel=2, replace_with_kernel_inject=True)``
     — 3,429,048,320 parameters a rank, K1 == 32 × forwards on 16:16
     heads, the last-position logits of phase 21's first row within 2·e of
     one card's (e phase 21's), a short greedy buffer equal to one card's
     up to a bf16 tie;
     (b) training, in phase 25's W = 4 spawn as data 2 x tensor 2:
     Llama-125M as phase 6 (bf16, AdamW, ZeRO-2, remat ``flash_saveable``,
     S 1024) on B 8, 4 rows a data rank — a rank's 67,062,528 parameters
     (of 134,105,856) and its state bytes against the reckoning,
     K1/K2a/K2b 12 a step on 6:6 heads, the first loss within 1e-2 of phase
     6's engine on the same rows; then float32 at 2 layers, stages 0 and 3,
     losses within rtol 1e-5 of phase 25's data-parallel run of the same
     world (W = 4, tensor 1, the same batch), the replicated tensors
     bit-identical on every rank.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line, if
there is no GPU or any phase fails.
"""

import atexit
import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import weakref
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.v2 import (PagedKVConfig, RaggedInferenceEngineConfig, SchedulerConfig,
                                              SpecConfig, build_cache_model, build_engine, build_hf_engine)
from deepspeed_tpu_torch.inference.quantization import _quantize_leaf, quantize_inference_params
from deepspeed_tpu_torch.inference.v2.model_implementations import FalconPolicy, Qwen2MoePolicy, policy_for
from deepspeed_tpu_torch.models import gpt_family
from deepspeed_tpu_torch.models.falcon import FalconConfig, FalconForCausalLM
from deepspeed_tpu_torch.models.gpt2 import PRESETS as GPT2_PRESETS
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
from deepspeed_tpu_torch.models.llama import PRESETS, LlamaConfig, LlamaForCausalLM, causal_lm_loss, init_weights_
from deepspeed_tpu_torch.models.mixtral import PRESETS as MIXTRAL_PRESETS
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM, make_mixtral_loss_fn
from deepspeed_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
from deepspeed_tpu_torch.models.phi import PhiConfig, PhiForCausalLM
from deepspeed_tpu_torch.moe import MoE
from deepspeed_tpu_torch.models.llama_cache import LlamaForCausalLMWithCache, kv_heads
from deepspeed_tpu_torch.models.llama_cache import paged_attention as paged_attention_plain
from deepspeed_tpu_torch.ops.op_builder import KERNEL_SOURCES, build_kernel
from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_plain, flash_delta_plain, flash_dkv_cuda,
                                                     flash_dq_cuda, flash_fwd_cuda, flash_fwd_plain)
from deepspeed_tpu_torch.ops.paged_attention import (choose_n_split, merge_partials_cuda, merge_partials_plain,
                                                     mma_probe_cuda, paged_attention_cuda,
                                                     paged_attention_partials_cuda)
from deepspeed_tpu_torch.ops.quant_kernels import (Q4_ROUTES, SegmentTable, dequantize_int4_cuda,
                                                   dequantize_int8_cuda, quantize_int4_cuda, quantize_int8_cuda)
from deepspeed_tpu_torch.ops.quantizer import dequantize_int4 as dequantize_int4_plain
from deepspeed_tpu_torch.ops.quantizer import dequantize_int8 as dequantize_int8_plain
from deepspeed_tpu_torch.ops.quantizer import dequantize_int8_grouped as dequantize_int8_grouped_plain
from deepspeed_tpu_torch.ops.quantizer import quantize_int4 as quantize_int4_plain
from deepspeed_tpu_torch.ops.quantizer import quantize_int8 as quantize_int8_plain
from deepspeed_tpu_torch.ops.quantizer import quantize_int8_grouped as quantize_int8_grouped_plain
from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                                                      DenseSparsityConfig, FixedSparsityConfig,
                                                      LocalSlidingWindowSparsityConfig, SparseSelfAttention,
                                                      VariableSparsityConfig, extend_position_embedding,
                                                      make_sparsity_config)
from deepspeed_tpu_torch.ops.sparse_attention.kernel import (EMPTY_ROW_LSE, build_tables, sparse_attn_bwd_plain,
                                                             sparse_attn_delta_plain, sparse_attn_dkv_cuda,
                                                             sparse_attn_dq_cuda, sparse_attn_fwd_cuda,
                                                             sparse_attn_fwd_plain)
from deepspeed_tpu_torch.checkpoint import engine as checkpoint_engine
from deepspeed_tpu_torch.resilience import atomic_io
from deepspeed_tpu_torch.resilience import events as resilience_events
from deepspeed_tpu_torch.runtime import checkpoint_engine as state_writers
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
from deepspeed_tpu_torch.utils.timer import TRAIN_BATCH_TIMER
from deepspeed_tpu_torch.serving import RequestState, ServingEngine, WallClock
from deepspeed_tpu_torch.serving.kvtier import TierConfig, TieredKVManager

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# H=32 query heads over n_kv=8 kv heads of D=128, as Llama-3-8B serves them
H, N_KV, D, PAGE = 32, 8, 128, 16
MAX_PAGES = 128
# |kernel - plain| <= ATOL + RTOL·|plain|.  bf16: both versions round p to
# bf16 (the plain one after normalising, the kernel before) and round the
# output to bf16, one ulp of which is 2^-8 relative, so a few ulps relative
# plus 1e-2 absolute for small outputs.  float32: only the summation order
# and exp differ.
TOLERANCE = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
LAUNCH_COUNTERS = (paged_attention_cuda, flash_fwd_cuda, flash_dq_cuda, flash_dkv_cuda, sparse_attn_fwd_cuda,
                   sparse_attn_dq_cuda, sparse_attn_dkv_cuda, quantize_int8_cuda, dequantize_int8_cuda,
                   quantize_int4_cuda, dequantize_int4_cuda)


def reset_launch_counts() -> None:
    """Every kernel's launch count to 0: done just before each path is driven."""
    for fn in LAUNCH_COUNTERS:
        fn.launches = 0
    paged_attention_cuda.split_calls = 0
    quantize_int4_cuda.routes = dict.fromkeys(Q4_ROUTES, 0)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's heading gets the script's seconds so far."""
    if msg.startswith("== "):
        msg = f"{msg} [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1


def host_memory() -> dict:
    """``MemTotal`` and ``MemAvailable`` of ``/proc/meminfo``, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(value.split()[0]) * 1024
    return out


def phase_environment() -> dict:
    smi = card()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    mem = host_memory()
    log(f"host memory: MemTotal {mem['MemTotal'] / 1e9:.2f} GB, MemAvailable {mem['MemAvailable'] / 1e9:.2f} GB")
    t_all = time.perf_counter()

    def build(name):
        t0 = time.perf_counter()
        return build_kernel(name), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:   # one nvcc per source, all at once
        built = dict(zip(KERNEL_SOURCES, pool.map(build, KERNEL_SOURCES)))
    for name, (output, seconds) in built.items():
        log(f"  {name}: nvcc {seconds:.2f} s" + ("" if output else " (already built)"))
        for line in output.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    {line.strip()}")
    log(f"kernels built in {time.perf_counter() - t_all:.2f} s")
    regs = ptxas_report(built["sparse_attention"][0], ("sparse_dq_kernel_tc", "sparse_dkv_kernel_tc"))
    log("  sparse_dq_kernel_tc / sparse_dkv_kernel_tc (D, CTA rows): " + json.dumps(regs))
    flash_regs = ptxas_report(built["flash_attention"][0], ("flash_fwd_kernel_tc", "flash_dq_kernel_tc",
                                                            "flash_dkv_kernel_tc"))
    log("  flash_fwd_kernel_tc / flash_dq_kernel_tc / flash_dkv_kernel_tc (D): " + json.dumps(flash_regs))
    spills = {k: r for k, r in {**regs, **flash_regs}.items() if r["spill_bytes"]}
    if spills:
        raise AssertionError(f"ptxas spills in the bf16 K6b/K6c or K1/K2a/K2b: {spills}")
    return {"card": smi, "sparse_bwd_registers": regs, "flash_registers": flash_regs, "host_memory": mem}


def ptxas_report(output: str, names) -> dict:
    """``name D=..`` (``ROWS=..``) → registers and spill bytes of each
    instantiation of the kernels ``names`` (``template <int D>`` or
    ``template <int D, int ROWS>``), from nvcc's ``-Xptxas -v`` output;
    empty when the library was already built."""
    out, key = {}, None
    for line in output.splitlines():
        if "Compiling entry" in line or "Function properties for" in line:
            key = None
            m = re.search(r"(" + "|".join(names) + r")I((?:Li\d+E)+)E", line)
            if m:
                args = re.findall(r"Li(\d+)E", m.group(2))
                key = f"{m.group(1)} D={args[0]}" + (f" ROWS={args[1]}" if len(args) > 1 else "")
                out.setdefault(key, {"registers": None, "spill_bytes": 0})
        elif key and "spill" in line:
            out[key]["spill_bytes"] += sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif key and "Used" in line and "registers" in line:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


# ---------------------------------------------------------------- phase 2


def make_case(starts, clens, c, dtype, seed, h=H, n_kv=N_KV, d=D, max_pages=MAX_PAGES, window=0, slopes=None):
    """A paged arena of random K/V with per-sequence block tables over
    shuffled physical pages; rows with clen 0 keep an all-null table.
    ``window`` (> 0) and ``slopes`` (alibi, float32 [H]) ride with the case."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    need = [-(-(s + n) // PAGE) if n > 0 else 0 for s, n in zip(starts, clens)]
    n_pages = 1 + sum(need)
    phys = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1).tolist()
    bt = torch.zeros((len(starts), max_pages), dtype=torch.int32)
    for i, n in enumerate(need):
        bt[i, :n] = torch.tensor(phys[:n], dtype=torch.int32)
        phys = phys[n:]
    pages = torch.randn((n_pages, PAGE, 2, n_kv, d), generator=gen, device="cuda").to(dtype)
    q = torch.randn((len(starts), c, h, d), generator=gen, device="cuda").to(dtype)
    return dict(q=q, pages=pages, block_table=bt.cuda(), start_pos=torch.tensor(starts, dtype=torch.int32).cuda(),
                chunk_lens=torch.tensor(clens, dtype=torch.int32).cuda(), page_size=PAGE, window=window,
                slopes=None if slopes is None else torch.as_tensor(slopes, dtype=torch.float32).cuda())


def case_args(case) -> tuple:
    return (case["q"], case["pages"], case["block_table"], case["start_pos"], case["chunk_lens"], PAGE)


def case_masks(case) -> dict:
    """The case's window and alibi slopes as K3's keyword arguments."""
    return {"sliding_window": case.get("window", 0), "alibi_slopes": case.get("slopes")}


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` with a cold L2: every launch is preceded
    by a write of ``flush`` (larger than the 50 MB L2) and a ~1 ms device
    spin, which keeps the card busy while the host enqueues the timed work,
    so host launch latency stays out of the reading.  The collector is off
    while it runs: a full collection of the objects earlier phases left
    (tens of ms) between ``start.record()`` and the launch would be read as
    device time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    gc.disable()
    try:
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
    finally:
        gc.enable()
    return total / iters


def bound_ms(case, dtype) -> tuple:
    """Least time for the work: the bytes it must move — each live KV byte
    (with a window, the keys some row of the sequence sees), the q rows of
    real queries (a padding row's output is zero whatever its q holds), the
    live block-table entries, start_pos and chunk_lens (and the slopes) read
    once, every out row (zeros included) written once — against the flops
    the visible keys need."""
    esize = torch.finfo(dtype).bits // 8
    b, c, h, d = case["q"].shape
    n_kv = case["pages"].shape[3]
    starts = case["start_pos"].tolist()
    clens = case["chunk_lens"].tolist()
    w = case.get("window", 0) or 1 << 40
    first = [max(0, s - w + 1) for s in starts]     # the first key the sequence's first row sees
    live_keys = sum(s + n - f for s, n, f in zip(starts, clens, first) if n > 0)
    live_pages = sum(-(-(s + n) // PAGE) - f // PAGE for s, n, f in zip(starts, clens, first) if n > 0)
    row_bytes = h * d * esize
    nbytes = (live_keys * 2 * n_kv * d * esize + sum(clens) * row_bytes + b * c * row_bytes +
              4 * (live_pages + 2 * b) + (4 * h if case.get("slopes") is not None else 0))
    flops = sum(4 * h * d * min(w, s + j + 1) for s, n in zip(starts, clens) for j in range(n))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_inputs(case):
    """q [B, H, C, D], K/V gathered per sequence [B, H, S, D] (GQA heads
    repeated) and the boolean mask of what each row may see."""
    q, pages, bt = case["q"], case["pages"], case["block_table"]
    b, c, h, d = q.shape
    n_kv = pages.shape[3]
    s_max = max(1, max(s + n for s, n in zip(case["start_pos"].tolist(), case["chunk_lens"].tolist())))
    n_pg = -(-s_max // PAGE)
    g = pages[bt[:, :n_pg].reshape(-1).long()].reshape(b, n_pg * PAGE, 2, n_kv, d)[:, :s_max]
    k = g[:, :, 0].repeat_interleave(h // n_kv, dim=2).transpose(1, 2).contiguous()
    v = g[:, :, 1].repeat_interleave(h // n_kv, dim=2).transpose(1, 2).contiguous()
    qpos = case["start_pos"].long()[:, None] + torch.arange(c, device="cuda")[None, :]
    kpos = torch.arange(s_max, device="cuda")
    mask = kpos[None, None, :] <= qpos[..., None]
    if case.get("window"):
        mask = mask & (kpos[None, None, :] > qpos[..., None] - case["window"])
    mask = mask[:, None]
    if case.get("slopes") is not None:   # alibi as an additive bias, -inf where hidden
        bias = case["slopes"][:, None, None] * kpos.float() / math.sqrt(d)            # [H, 1, S]
        mask = torch.where(mask, bias[None].to(q.dtype), float("-inf"))
    return q.transpose(1, 2).contiguous(), k, v, mask


def k3_ratio(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """Largest |got − want| over the TOLERANCE limit: at most 1 passes."""
    atol, rtol = TOLERANCE[dtype]
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())


def run_case(name, case, dtype, flush, timed=True, n_split=None) -> dict:
    args, masks = case_args(case), case_masks(case)
    b, c, h, d = case["q"].shape
    split = 1 if dtype == torch.float32 else n_split or choose_n_split(b, c, h, case["pages"].shape[3], d,
                                                                          case["block_table"].shape[1] * PAGE)
    got = paged_attention_cuda(*args, n_split=n_split, **masks)
    want = paged_attention_plain(*args, **masks)
    torch.cuda.synchronize()
    max_err = float((got.float() - want.float()).abs().max())
    ratio = k3_ratio(got, want, dtype)
    pad = case["chunk_lens"] == 0
    if bool(pad.any()) and not bool((got[pad] == 0).all()):
        raise AssertionError(f"{name}: padding rows are not zero")
    if not ratio <= 1:
        atol, rtol = TOLERANCE[dtype]
        raise AssertionError(f"{name}: kernel disagrees with the plain version: max |err| {max_err:.3e}, "
                             f"|err|/limit {ratio:.3g} (tolerance {atol} + {rtol}·|plain|)")
    row = {"case": name, "n_split": split, "max_abs_err": max_err, "err_over_limit": ratio}
    b_ms, b_by = bound_ms(case, dtype)
    row.update(bound_ms=b_ms, bound_by=b_by)
    if timed:
        row["ms"] = time_ms(lambda: paged_attention_cuda(*args, n_split=n_split, **masks), 20, flush)
        row["plain_ms"] = time_ms(lambda: paged_attention_plain(*args, **masks), 5, flush)
        qs, ks, vs, mask = sdpa_inputs(case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask), 10, flush)
        row["bound_share"] = b_ms / row["ms"]
    log(f"  K3 {name}: " + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                                     for k, v in row.items() if k != "case"))
    return row


def k3_mutants(decode, prefill) -> dict:
    """Faulty kernels the check must reject, made from the kernels' outputs:
    the split route with one split's partial dropped for the longest decode
    row; the causal edge off by one (the key at start + c hidden: the plain
    version one position early); one head of a row tile attending with its
    neighbour's q.  Each must exceed the TOLERANCE limit."""
    args = case_args(decode)
    want = paged_attention_plain(*args)
    longest = int(decode["start_pos"].argmax())
    m, l, o = paged_attention_partials_cuda(*args, 4)
    m[0, longest] = -float("inf")                 # split 0 holds keys 0..511 of the 2000-key row
    dropped = merge_partials_cuda(m, l, o, decode["chunk_lens"])
    pargs = list(case_args(prefill))
    pwant = paged_attention_plain(*pargs)
    early = paged_attention_plain(*pargs[:3], pargs[3] - 1, *pargs[4:])
    q_swapped = pargs[0].clone()
    q_swapped[:, :, 1] = pargs[0][:, :, 2]        # head 1 of kv group 0 takes head 2's q
    swapped = paged_attention_cuda(*pargs)
    swapped[:, :, 1] = paged_attention_plain(q_swapped, *pargs[1:])[:, :, 1]
    caught = {"split_dropped": k3_ratio(dropped, want, torch.bfloat16),
              "causal_edge_off_by_one": k3_ratio(early, pwant, torch.bfloat16),
              "neighbour_q": k3_ratio(swapped, pwant, torch.bfloat16)}
    log("  K3 faulty kernels' |err|/limit: " + ", ".join(f"{n}={r:.4g}" for n, r in caught.items()))
    if not all(r > 1 for r in caught.values()):
        raise AssertionError(f"K3: the check passes a faulty kernel: {caught}")
    return caught


def k3_fragments() -> dict:
    """One m16n8k16 product through the kernel's fragment loaders against
    torch.matmul (float32 sums of bf16 products: exact up to order)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    a, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in ((16, 16), (8, 16), (16, 8)))
    c1, c2 = mma_probe_cuda(a, k, v)
    err = {"q_kt": float((c1 - a.float() @ k.float().t()).abs().max()),
           "p_v": float((c2 - a.float() @ v.float()).abs().max())}
    log(f"  K3 one mma (ldmatrix, ldmatrix.trans) vs torch.matmul: max |err| {err}")
    if not all(e <= 1e-4 for e in err.values()):
        raise AssertionError(f"K3 mma fragments disagree with torch.matmul: {err}")
    return err


def k3_merge(decode) -> dict:
    """The merge kernel against merge_partials_plain on the split kernel's
    partials of the decode case (empty splits included)."""
    args = case_args(decode)
    n = choose_n_split(*decode["q"].shape[:3], N_KV, D, MAX_PAGES * PAGE)
    m, l, o = paged_attention_partials_cuda(*args, n)
    got = merge_partials_cuda(m, l, o, decode["chunk_lens"])
    want = merge_partials_plain(m, l, o, decode["chunk_lens"])
    torch.cuda.synchronize()
    empty = int((m == -float("inf")).sum())
    ratio = k3_ratio(got, want, torch.bfloat16)
    log(f"  K3 merge kernel vs merge_partials_plain: n_split={n}, empty partials {empty} of {m.numel()}, "
        f"|err|/limit {ratio:.4g}")
    if not (ratio <= 1 and empty > 0):
        raise AssertionError(f"K3 merge kernel: |err|/limit {ratio}, empty partials {empty}")
    return {"n_split": n, "empty_partials": empty, "err_over_limit": ratio}


# the zoo's K3 shapes (phases 16-18): Falcon-7B's 71 query heads on one
# kv head of 64; Mistral-7B's window of 4096 over 6000-key contexts; Falcon-RW-1B's
# alibi over 32 heads of 64 (MHA); Phi-2's and Phi-3's head dims 80 and 96 at
# Llama-3-8B's heads; Qwen1.5-MoE's 16 heads of 128 (MHA); Mixtral's are
# Llama-3-8B's (32:8, D 128)
WINDOW = 4096
WINDOW_PAGES = 384                 # 6144 keys a sequence
WINDOW_SHORT = 32                  # an untimed window short enough that one key is visible in the output
QWEN_MOE_HEADS = dict(h=16, n_kv=16, d=128)   # Qwen1.5-MoE-A2.7B's attention (phase 18)


def zoo_shapes(rng) -> dict:
    """name → (starts, chunk lens, C, make_case keywords) of the zoo's K3 rows."""
    from deepspeed_tpu_torch.models.falcon import alibi_slopes
    ctx = rng.integers(1, 2001, 16)
    ctx[0], ctx[-1] = 1, 2000
    decode = ([int(x) - 1 for x in ctx], [1] * 16, 1)
    prefill = ([0, 256, 768, 1536], [256, 256, 256, 200], 256)
    wctx = rng.integers(5000, 6001, 16)
    wctx[0] = 6000
    wdecode = ([int(x) - 1 for x in wctx], [1] * 16, 1)
    wprefill = ([5744, 5400, 4100, 3000], [256, 256, 256, 256], 256)
    falcon = dict(h=71, n_kv=1, d=64)
    window = dict(max_pages=WINDOW_PAGES, window=WINDOW)
    alibi = dict(h=32, n_kv=32, d=64, slopes=alibi_slopes(32))
    return {"d80_decode": (*decode, dict(d=80)), "d80_prefill": (*prefill, dict(d=80)),
            "d96_decode": (*decode, dict(d=96)), "d96_prefill": (*prefill, dict(d=96)),
            "falcon7b_decode": (*decode, falcon), "falcon7b_chunk": (*prefill, falcon),
            "window_decode": (*wdecode, window), "window_prefill": (*wprefill, window),
            "alibi_decode": (*decode, alibi),
            "qwen_moe_decode": (*decode, QWEN_MOE_HEADS), "qwen_moe_prefill": (*prefill, QWEN_MOE_HEADS)}


def k3_zoo(flush) -> dict:
    """The zoo's K3 rows against the plain version, timed in bf16 (with the
    SDPA library call on the same mask or bias), and in float32 (the scalar
    kernel's variants) untimed; then the faulty kernels of the zoo's
    routes."""
    rng = np.random.default_rng(30)
    shapes = zoo_shapes(rng)
    cases = {name: make_case(starts, clens, c, torch.bfloat16, seed=40 + i, **kw)
             for i, (name, (starts, clens, c, kw)) in enumerate(shapes.items())}
    rows = {name: run_case(name, case, torch.bfloat16, flush) for name, case in cases.items()}
    for name in ("d80_decode", "d96_prefill", "falcon7b_decode", "window_decode", "window_prefill", "alibi_decode"):
        starts, clens, c, kw = shapes[name]
        rows[f"{name}_f32"] = run_case(f"{name}_f32", make_case(starts, clens, c, torch.float32, seed=60, **kw),
                                       torch.float32, flush, timed=False)
    for name in ("falcon7b_decode", "window_decode"):   # split and unsplit must agree with the plain version
        run_case(f"{name}_unsplit", cases[name], torch.bfloat16, flush, timed=False, n_split=1)
    if not (rows["falcon7b_decode"]["n_split"] > 1 and rows["window_decode"]["n_split"] > 1):
        raise AssertionError("the zoo's decode rows did not take the split route")
    starts, clens, c, _ = shapes["d80_decode"]
    short = make_case(starts, clens, c, torch.bfloat16, seed=61, window=WINDOW_SHORT)
    run_case("window_short_decode", short, torch.bfloat16, flush, timed=False)
    k3_zoo_mutants(cases, short)
    return rows


def k3_zoo_mutants(cases, short) -> dict:
    """Faulty kernels of the zoo's routes the check must reject (each beyond
    the TOLERANCE limit): the window ignored; the window one key too short
    (at a window of WINDOW_SHORT keys, where one key shows); each head with
    its neighbour's alibi slope; Falcon-7B's second row tile (heads 64-70)
    with the first tile's output; head dim 80 with its last 16 dims lost."""
    bf = torch.bfloat16

    def against_plain(case, got, **masks):
        return k3_ratio(got, paged_attention_plain(*case_args(case), **(masks or case_masks(case))), bf)

    w, a, f, d80 = cases["window_decode"], cases["alibi_decode"], cases["falcon7b_decode"], cases["d80_decode"]
    second_tile = paged_attention_cuda(*case_args(f))
    second_tile[:, :, 64:71] = second_tile[:, :, 0:7]
    tail = paged_attention_cuda(*case_args(d80))
    tail[..., 64:] = 0
    caught = {"window_ignored": against_plain(w, paged_attention_cuda(*case_args(w))),
              "window_off_by_one": against_plain(short, paged_attention_cuda(*case_args(short),
                                                                                sliding_window=WINDOW_SHORT - 1),
                                                 sliding_window=WINDOW_SHORT),
              "alibi_neighbour_slope": against_plain(a, paged_attention_cuda(*case_args(a),
                                                                             alibi_slopes=a["slopes"].roll(1))),
              "rep71_second_tile": against_plain(f, second_tile),
              "d80_tail_lost": against_plain(d80, tail)}
    log("  K3 zoo faulty kernels' |err|/limit: " + ", ".join(f"{n}={r:.4g}" for n, r in caught.items()))
    if not all(r > 1 for r in caught.values()):
        raise AssertionError(f"K3: the check passes a faulty zoo kernel: {caught}")
    return caught


def tp_zoo_k3_heads() -> dict:
    """label → ``make_case`` keywords of phase 27(a)'s zoo ranks at tensor 2:
    Phi-2's, OPT-6.7B's and Falcon-RW-1B's 16 heads a rank (the last with
    the alibi slopes of tensor rank 1's heads)."""
    from deepspeed_tpu_torch.models.falcon import rank_alibi_slopes
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel
    rw = policy_for("falcon").build_config(ZOO["falcon-rw-1b"][0])
    slopes = rank_alibi_slopes(rw, TensorParallel(TP_SIZE, 1), "cpu").numpy()
    return {"tp_phi2": dict(h=16, n_kv=16, d=80), "tp_opt": dict(h=16, n_kv=16, d=128),
            "tp_falcon_rw": dict(h=16, n_kv=16, d=64, slopes=slopes)}


def phase_kernels() -> dict:
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(0)
    ctx = rng.integers(1, 2001, 16)
    ctx[0], ctx[-1] = 1, 2000
    decode = ([int(x) - 1 for x in ctx], [1] * 16, 1)
    prefill = ([0, 256, 768, 1536], [256, 256, 256, 200], 256)
    # a mixed SplitFuse step: two prefill rows, three decode rows, three
    # padding rows (chunk_len 0, all-null block table)
    mixed = ([0, 512, 900, 33, 1999, 0, 0, 0], [256, 130, 1, 1, 1, 0, 0, 0], 256)
    decode_long = ([1999] * 16, [1] * 16, 1)   # every sequence at 2000 keys
    # a speculative verify round: 8 rows of the last token and 4 drafts
    verify = ([int(x) for x in rng.integers(64, 1020, 8)], [5] * 8, 5)
    k3_fragments()
    cases = {name: make_case(*shape, torch.bfloat16, seed=i)
             for i, (name, shape) in enumerate((("decode", decode), ("prefill", prefill), ("mixed", mixed),
                                                ("decode_long", decode_long), ("verify", verify)))}
    rows = {name: run_case(name, case, torch.bfloat16, flush) for name, case in cases.items()}
    rows["decode_f32"] = run_case("decode_f32", make_case(*decode, torch.float32, seed=7), torch.float32, flush,
                                  timed=False)
    if not (rows["decode"]["n_split"] > 1 and rows["decode_long"]["n_split"] > 1):
        raise AssertionError(f"decode did not take the split route: {rows['decode']}, {rows['decode_long']}")
    # empty splits: at 8 splits of 256 keys the 1-key row and every row
    # under 1793 keys leave splits empty; whole (one split) for comparison
    run_case("decode_8_splits", cases["decode"], torch.bfloat16, flush, timed=False, n_split=8)
    run_case("decode_unsplit", cases["decode"], torch.bfloat16, flush, timed=False, n_split=1)
    # rep 1 at head dim 64: 16 heads of their own kv head, a chunk and decode
    for name, shape in (("rep1_d64_chunk", prefill), ("rep1_d64_decode", decode)):
        run_case(name, make_case(*shape, torch.bfloat16, seed=9, h=16, n_kv=16, d=64), torch.bfloat16, flush,
                 timed=False)
    # phase 27's shapes: a tensor-2 rank's heads of Llama-3-8B (16:4) and of Qwen1.5-MoE (8:8), D 128, its batch
    # of 4 requests at their last decode step (phase 27's prompt lengths, 15 tokens on) at the split the wrapper
    # picks, and a chunk; timed with their plain versions and SDPA
    tp_decode = [n + TP_NEW - 1 for n in tp_prompt_lengths()]
    for label, heads in (("tp_16_4", dict(h=16, n_kv=4, d=128)), ("tp_8_8", dict(h=8, n_kv=8, d=128))):
        rows[f"{label}_decode"] = run_case(f"{label}_decode", make_case(tp_decode, [1] * 4, 1, torch.bfloat16,
                                                                        seed=14, **heads), torch.bfloat16, flush)
        rows[f"{label}_chunk"] = run_case(f"{label}_chunk", make_case(*prefill, torch.bfloat16, seed=15, **heads),
                                          torch.bfloat16, flush)
    if rows["tp_16_4_decode"]["n_split"] != TP_K3_SPLIT:
        raise AssertionError(f"K3 at 16:4 chose {rows['tp_16_4_decode']['n_split']} splits, not {TP_K3_SPLIT}")
    # phase 27(a)'s zoo ranks at tensor 2: Phi-2 (16:16, D 80), OPT-6.7B (16:16, D 128) and Falcon-RW-1B (16:16,
    # D 64, alibi with the second rank's slopes: heads 16-31 of the model's 32), the same batch and chunk
    for label, heads in tp_zoo_k3_heads().items():
        rows[f"{label}_decode"] = run_case(f"{label}_decode", make_case(tp_decode, [1] * 4, 1, torch.bfloat16,
                                                                        seed=16, **heads), torch.bfloat16, flush)
        rows[f"{label}_chunk"] = run_case(f"{label}_chunk", make_case(*prefill, torch.bfloat16, seed=17, **heads),
                                          torch.bfloat16, flush)
    k3_merge(cases["decode"])
    k3_mutants(cases["decode"], cases["prefill"])
    # how the decode time moves with the split, at four decode batches (the
    # wrapper picks n_split from shapes: the lengths live on the device)
    sweeps = {"decode": cases["decode"], "decode_long": cases["decode_long"],
              "decode_b8": make_case([500 + 13 * i for i in range(8)], [1] * 8, 1, torch.bfloat16, seed=12),
              "decode_b4": make_case([1000, 1300, 1700, 1999], [1] * 4, 1, torch.bfloat16, seed=13)}
    for name, case in sweeps.items():
        b = case["q"].shape[0]
        sweep = {n: time_ms(lambda: paged_attention_cuda(*case_args(case), n_split=n), 20, flush)
                 for n in range(1, 9)}
        chosen = choose_n_split(b, 1, H, N_KV, D, MAX_PAGES * PAGE)
        log(f"  K3 {name} (B {b}) ms by n_split (chosen {chosen}): " +
            json.dumps({str(k): round(v, 5) for k, v in sweep.items()}))
        if name in rows:
            rows[name]["ms_by_n_split"] = sweep
    rows.update(k3_zoo(flush))
    return rows


# ---------------------------------------------------------------- phase 3


def llama3_8b(layers: int, dtype: torch.dtype, seed: int) -> tuple:
    """Llama-3-8B at full width, ``layers`` deep, random weights from a
    seeded generator, stored in the compute dtype."""
    cfg = dataclasses.replace(PRESETS["llama3-8b"], num_hidden_layers=layers, dtype=dtype, param_dtype=dtype,
                              attention_impl="flash")
    model = LlamaForCausalLMWithCache(cfg, page_size=PAGE, device="cuda")
    init_weights_(model, torch.Generator(device="cuda").manual_seed(seed))
    return cfg, model.state_dict()


def engine_config(dtype: torch.dtype, num_pages: int, max_pages: int = MAX_PAGES) -> RaggedInferenceEngineConfig:
    return RaggedInferenceEngineConfig(kv=PagedKVConfig(num_pages=num_pages, page_size=PAGE, max_pages_per_seq=max_pages),
                                       scheduler=SchedulerConfig(token_budget=512, max_seqs=8, prefill_chunk=256,
                                                                 decode_bucket=8),
                                       max_new_tokens=64, kv_dtype=dtype, enable_prefix_cache=True,
                                       decode_steps_per_dispatch=8)


def serving_mix(vocab: int) -> tuple:
    """Phase 3's 8 requests: prompts of 64-1024 tokens, the last sharing
    512 tokens with the second, and 32-64 new tokens each."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).tolist() for n in (64, 1024, 300, 700, 128, 512, 900, 100)]
    prompts[7] = prompts[1][:512] + prompts[7]             # shares 32 full pages with request 1
    return prompts, rng.integers(32, 65, len(prompts)).tolist()


def phase_serving(cfg, state, smi: str) -> dict:
    eng = build_engine(cfg, state, engine_config(torch.bfloat16, 1024), device="cuda")
    res = serve_mix(eng, *serving_mix(cfg.vocab_size), smi)
    res["tp_reference"] = tp_reference(eng, state)
    return res


def serve_mix(eng, prompts, max_new, smi: str) -> dict:
    """Phase 3's serving run on ``eng``: the requests put at once but the
    eighth (admitted when the second has its first token), stepped to the
    end; tokens, pages, the prefix hit, K3 == layers x forwards and the
    split route checked; tok/s and TTFT."""
    cfg = eng.cfg
    layers = cfg.num_hidden_layers
    log(f"  {layers} layers, hidden {cfg.hidden_size}, {cfg.num_attention_heads}/{kv_heads(cfg)} heads of "
        f"{cfg.hidden_size // cfg.num_attention_heads}, vocab {cfg.vocab_size}, {cfg.dtype}")
    eng.generate([list(range(1, 20))], max_new_tokens=9)  # warm-up: cuBLAS handles, allocator
    pc = eng.kv.prefix_cache
    pc.evict(pc.cached_pages)
    free0 = eng.kv.allocator.free_pages
    lens = [len(p) for p in prompts]
    late = 7                                               # admitted once request 1 has its first token

    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    eng.forward_calls = 0
    t0 = time.perf_counter()
    put_t, reused = {}, {}    # reused: prompt tokens whose KV the prefix cache supplied at admission
    for uid in range(len(prompts)):
        if uid != late:
            eng.put([uid], [prompts[uid]], max_new_tokens=max_new[uid])
            put_t[uid] = t0
            reused[uid] = eng.state.seqs[uid].seen_tokens
    first, steps = {}, []
    while any(not s.done for s in eng.state.seqs.values()) or late not in put_t:
        if len(steps) > 1000:
            raise AssertionError("serving made no progress in 1000 steps")
        ts = time.perf_counter()
        out = eng.step()                                    # ends in the step's readback
        now = time.perf_counter()
        steps.append((ts, now, sum(len(v) for v in out.values()), len(first) == len(prompts)))
        for uid, toks in out.items():
            first.setdefault(uid, now)
        if late not in put_t and 1 in first:
            eng.put([late], [prompts[late]], max_new_tokens=max_new[late])
            put_t[late] = time.perf_counter()
            reused[late] = eng.state.seqs[late].seen_tokens
    t_end = time.perf_counter()
    launches, forwards = paged_attention_cuda.launches, eng.forward_calls
    split_calls = paged_attention_cuda.split_calls

    for uid in range(len(prompts)):
        got = len(eng.state.seqs[uid].generated)
        if got != max_new[uid]:
            raise AssertionError(f"request {uid} produced {got} tokens, asked for {max_new[uid]}")
    hits = pc.hits
    for uid in range(len(prompts)):
        eng.flush(uid)
    pc.evict(pc.cached_pages)
    if eng.kv.allocator.free_pages != free0:
        raise AssertionError(f"pages leaked: {eng.kv.allocator.free_pages} free after flush, {free0} before")
    if hits < 1 or reused[late] == 0:
        raise AssertionError(f"the shared-prefix request did not hit the prefix cache: {reused}")
    if launches != layers * forwards or launches == 0:
        raise AssertionError(f"K3 launched {launches} times over {forwards} forwards of {layers} layers")
    if split_calls == 0:
        raise AssertionError("no K3 call of the decode rounds took the split route")

    # prefill tok/s: prompt tokens computed over the time to the last first
    # token; decode tok/s: tokens of the steps after every request had its
    # first token, over those steps' time
    ttft = {uid: first[uid] - put_t[uid] for uid in first}
    t_prefilled = max(first.values())
    prefill_tokens = sum(lens) - sum(reused.values())
    decode_steps = [s for s in steps if s[3]]
    decode_tokens = sum(s[2] for s in decode_steps)
    decode_s = sum(s[1] - s[0] for s in decode_steps)
    res = {"requests": len(prompts), "prompt_tokens": sum(lens), "generated": sum(max_new), "steps": len(steps),
           "forwards": forwards, "k3_launches": launches, "k3_split_calls": split_calls, "prefix_hits": hits,
           "prefix_tokens_reused": sum(reused.values()),
           "prefill_tok_s": prefill_tokens / (t_prefilled - t0), "decode_tok_s": decode_tokens / decode_s,
           "ttft_ms_mean": 1e3 * float(np.mean(list(ttft.values()))), "ttft_ms_max": 1e3 * max(ttft.values()),
           "wall_s": t_end - t0, "peak_mem_gb": acc.max_memory_allocated() / 1e9, "card": smi}
    log("  serving: " + json.dumps(res))
    return res


# ---------------------------------------------------------------- phase 4


def parity_f32_prompts(vocab: int) -> list:
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, n).tolist() for n in (40, 300, 700)]


def parity_prompt(vocab: int) -> list:
    """Phase 4's bf16 prompt (200 tokens: one prefill chunk)."""
    return np.random.default_rng(3).integers(0, vocab, 200).tolist()


def phase_parity_f32() -> dict:
    """Greedy streams of the kernel path and the plain path, float32,
    Llama-3-8B width, 2 layers: identical.  The kernel path's streams and
    its first-step logits of ``parity_prompt`` are phase 27's one-card
    float32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, state = llama3_8b(2, torch.float32, seed=1)
    econf = engine_config(torch.float32, 256)
    prompts = parity_f32_prompts(cfg.vocab_size)
    streams = {}
    for impl in ("flash", "reference"):
        eng = build_engine(dataclasses.replace(cfg, attention_impl=impl), state, econf, device="cuda")
        streams[impl] = eng.generate(prompts, max_new_tokens=24)
        if impl == "flash":
            logits = first_step_logits(eng, parity_prompt(cfg.vocab_size)).cpu().numpy()
        del eng
    if streams["flash"] != streams["reference"]:
        raise AssertionError(f"f32 greedy streams differ: {streams}")
    log(f"  f32 parity: {len(prompts)} greedy streams of 24 tokens identical on both paths")
    return {"f32_streams_identical": True, "streams": streams["flash"], "logits": logits}


def first_step_logits(eng, prompt) -> torch.Tensor:
    """Last-token logits of a prompt's first (single-chunk) step."""
    uid = 10_000
    eng.put([uid], [prompt], max_new_tokens=1)
    seq = eng.state.seqs[uid]
    rb = eng.state.pack([(seq, len(prompt))], eng.econfig.scheduler.prefill_chunk, pad_to=eng._bucket_batch(1))
    dev = [torch.from_numpy(a).cuda() for a in (rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens)]
    with torch.no_grad():
        if getattr(eng, "dequantizer", None) is not None:   # int8 weights: the tensors outside the layers, as a step does
            eng.dequantizer.before_step()
        logits = eng.model(dev[0], dev[1], dev[2], eng.cache, dev[3])[0, len(prompt) - 1].float()
    eng.flush(uid)
    return logits


def prompt_logits(eng, prompt, keep_from=None) -> torch.Tensor:
    """The logits after a prompt's last token (with ``keep_from``, after
    each of its tokens from that position on: [len(prompt) - keep_from, V]),
    the prompt prefilled chunk by chunk as the engine's scheduler cuts a
    lone request."""
    uid = 10_000
    first = len(prompt) - 1 if keep_from is None else keep_from
    eng.put([uid], [prompt], max_new_tokens=1)
    seq, chunk = eng.state.seqs[uid], eng.econfig.scheduler.prefill_chunk
    rows = []
    with torch.no_grad():
        while seq.seen_tokens < len(prompt):
            s0, n = seq.seen_tokens, min(chunk, len(prompt) - seq.seen_tokens)
            rb = eng.state.pack([(seq, n)], chunk, pad_to=eng._bucket_batch(1))
            dev = [torch.from_numpy(a).cuda() for a in (rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens)]
            if s0 + n > first:
                rows.append(eng.model(dev[0], dev[1], dev[2], eng.cache, dev[3])[0, max(0, first - s0):n].float())
            else:
                eng.model(dev[0], dev[1], dev[2], eng.cache, dev[3])
            seq.seen_tokens += n
    eng.flush(uid)
    logits = torch.cat(rows)
    return logits[0] if keep_from is None else logits


def phase_parity_bf16(cfg, state) -> dict:
    """First-step last-token logits of the bf16 kernel path and the bf16
    plain path, both held against the plain path in float32 on the same
    (upcast) weights.  Tolerance: the bf16 rounding error of the plain path
    itself, e = ||plain - f32|| / ||f32||.  Each of the layers rounds
    attention's probabilities and output to bf16 at other points on the two
    paths, and the residual stream carries the differences through depth,
    so the two bf16 paths may differ by about sqrt(2)·e; the kernel path must
    stay within 2·e of the plain path and within 1.5·e of float32."""
    prompt = parity_prompt(cfg.vocab_size)
    runs = {"flash": (cfg, state), "reference": (dataclasses.replace(cfg, attention_impl="reference"), state),
            "f32": (dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32,
                                        attention_impl="reference"), None)}
    logits = {}
    for name, (c, st) in runs.items():
        if st is None:
            st = {k: v.float() for k, v in state.items()}
        eng = build_engine(c, st, engine_config(c.dtype, 64), device="cuda")
        logits[name] = first_step_logits(eng, prompt)
        del eng, st
        torch.cuda.empty_cache()

    def rel(a, b):
        return float((logits[a] - logits[b]).norm() / logits[b].norm())

    res = {"kernel_vs_plain": rel("flash", "reference"), "kernel_vs_f32": rel("flash", "f32"),
           "plain_vs_f32": rel("reference", "f32"),
           "max_abs_kernel_vs_plain": float((logits["flash"] - logits["reference"]).abs().max()),
           "argmax_equal": bool(logits["flash"].argmax() == logits["reference"].argmax())}
    log(f"  bf16 parity ({cfg.num_hidden_layers} layers, relative L2 of logits): {json.dumps(res)}")
    e = res["plain_vs_f32"]
    if not (np.isfinite(res["kernel_vs_plain"]) and res["kernel_vs_plain"] <= 2 * e
            and res["kernel_vs_f32"] <= 1.5 * e):
        raise AssertionError(f"bf16 kernel path out of tolerance: {res}")
    res["f32_logits"] = logits["f32"].cpu().numpy()   # phase 27's float32 reference (not logged)
    return res


def phase_profile(cfg, state) -> dict:
    """Where a decode step's time goes: one fused decode dispatch (k rounds
    of 8 sequences at ~512-token contexts) under torch.profiler — the
    device time and the kernels that take it — and the wall time of the
    next, identical dispatch, not profiled.  The busy share is the device
    time over that unprofiled wall time (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    eng = build_engine(cfg, state, engine_config(cfg.dtype, 1024), device="cuda")
    rng = np.random.default_rng(4)
    uids = list(range(8))
    for u in uids:
        eng.put([u], [rng.integers(0, cfg.vocab_size, 512).tolist()], max_new_tokens=33)
    while not all(s.in_decode for s in eng.state.seqs.values()):
        eng.step()                                         # prefill
    eng.step()                                             # one decode dispatch, warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = eng.step()
        wall = time.perf_counter() - t0
    k = len(next(iter(out.values())))
    t0 = time.perf_counter()
    eng.step()                                             # the same dispatch, not profiled
    wall_plain = time.perf_counter() - t0
    # device rows only (kernels, memcpy/memset): a CPU op's row also carries
    # the device time of the kernels it launched
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in rows}
    busy_ms = sum(dev_us.values()) / 1e3
    k3_ms = sum(v for n, v in dev_us.items() if "paged_attention_tc_kernel" in n or "paged_merge_kernel" in n) / 1e3
    k4b_ms = sum(v for n, v in dev_us.items() if "dq8_kernel" in n) / 1e3    # int8 weights (phase 22)
    top = sorted(((v / 1e3, n) for n, v in dev_us.items() if v > 0), reverse=True)[:8]
    res = {"rounds": k, "wall_ms_per_round": 1e3 * wall_plain / k, "profiled_wall_ms_per_round": 1e3 * wall / k,
           "device_ms_per_round": busy_ms / k, "k3_device_ms_per_round": k3_ms / k,
           "k4b_device_ms_per_round": k4b_ms / k,
           "device_busy_share": busy_ms / (1e3 * wall_plain),
           "device_busy_share_profiled": busy_ms / (1e3 * wall), "device_ops_per_round": sum(e.count for e in rows) / k,
           "top_kernels_ms_per_round": [[n[:60], t / k] for t, n in top]}
    log("  decode profile: " + json.dumps(res))
    return res


# ---------------------------------------------------------------- phase 5

# training shapes: Llama-125M at the bench configuration, and Llama-3-8B
FLASH_SHAPES = {"bench": dict(b=24, s=1024, h=12, hk=12, d=64), "llama3-8b": dict(b=1, s=4096, h=32, hk=8, d=128)}
# the zoo's training shapes (phase 24): Phi-2's head dim 80, Phi-3-mini's 96,
# and Falcon-7B's 71 query heads on one kv head (the repeated-KV route)
FLASH_ZOO_SHAPES = {"phi-2": dict(b=2, s=2048, h=32, hk=32, d=80), "phi-3-mini": dict(b=2, s=2048, h=32, hk=32, d=96),
                    "falcon-7b": dict(b=2, s=2048, h=71, hk=1, d=64)}
# a tensor-2 rank's heads of Phi-2 in training (phase 25's data 2 x tensor 2 run: 16 of its 32 heads of 80)
FLASH_TP_SHAPES = {"phi-2 tp2": dict(b=2, s=2048, h=16, hk=16, d=80)}
# untimed shapes whose blocks hold rows that are not valid: at rep 3 a block
# has 63 rows (21 positions) and the last one stops at Sq; at rep 2 with a
# query offset the rows end at Sq 192, below the 256 keys
FLASH_EDGE_SHAPES = {"rep3": dict(b=2, h=6, hk=2, d=128), "tail": dict(b=2, h=4, hk=2, d=64)}
# Kernel against plain, element by element.  o, dq, dk, dv:
#   |kernel − plain| <= a·|plain| + b·rms(vector) + f·rms(tensor),
# the vector being the D values of one head at one query row (o, dq) or key
# (dk, dv).  a: the two versions round the same f32 value to the output
# dtype, at most one ulp apart (2^-7 relative in bf16).  b: the kernel rounds
# p (and ds) to bf16 at the online softmax's running max, the plain version
# at the row's final max; each rounding moves a term by up to 2^-9 of itself,
# so the sum moves by a few 2^-9 of the vector's own scale.  f: a floor for
# vectors that are cancellation noise (dq of a row that sees one key is 0 up
# to f32 rounding).  lse and delta are float32 statistics computed from the
# same f32 terms on both sides: |err| <= stat·(|plain| + rms(plain)).  The
# float32 kernels differ from the plain version only in summation order; the
# float32 floor f is set above the noise of the causal rows that see few
# keys (2^-16 failed on dq at Llama-3-8B shapes, H100 readings in PERF.md).
FLASH_TOL = {torch.bfloat16: dict(a=2**-7, b=2**-6, f=2**-8, stat=2**-14),
             torch.float32: dict(a=2**-16, b=2**-14, f=2**-14, stat=2**-16)}


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor, tol: dict, vector: bool) -> float:
    """Largest |got − want| over its limit (see FLASH_TOL): at most 1 passes."""
    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt()
    if vector:
        limit = tol["a"] * want.abs() + tol["b"] * want.square().mean(-1, keepdim=True).sqrt() + tol["f"] * rms
    else:
        limit = tol["stat"] * (want.abs() + rms)
    ratio = (got - want).abs() / limit.clamp_min(torch.finfo(torch.float32).tiny)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(ratio.max())


def flash_mutants(q, k, v, causal, q_offset, o, lse, dq, dk, dv) -> dict:
    """Faulty kernels the check must reject, made from the kernel's outputs:
    K1 that stops one kv tile (64 keys) short of the diagonal for the second
    half of the rows; K2a that zeroes dq of one query head in the last q tile;
    K2b that zeroes dk and dv of the last kv tile at or below the diagonal
    (the keys with the smallest gradients)."""
    sq, sk = q.shape[1], k.shape[1]
    half, tile = sq // 2, 64
    short_o, short_lse = flash_fwd_plain(q, k, v, causal, q_offset - tile)
    o_m, lse_m = o.clone(), lse.clone()
    o_m[:, half:], lse_m[:, :, half:] = short_o[:, half:], short_lse[:, :, half:]
    dq_m = dq.clone()
    dq_m[:, -tile:, -1] = 0
    t1 = min(sk, sq + q_offset) // tile * tile
    dk_m, dv_m = dk.clone(), dv.clone()
    dk_m[:, t1 - tile:t1] = 0
    dv_m[:, t1 - tile:t1] = 0
    return {"o": o_m, "lse": lse_m, "dq": dq_m, "dk": dk_m, "dv": dv_m}


def visible_keys(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """Keys seen by the Sq query rows of one head: the causal triangle, or all."""
    if not causal:
        return sq * sk
    return sum(min(sk, q_offset + i + 1) for i in range(sq))


def flash_bounds(b, sq, sk, h, hk, d, dtype, vis) -> dict:
    """Least time of each kernel: each input read once and each output
    written once, against 4/6/8·B·H·D·vis flops (QK+PV; QK, dO·Vᵀ, dS·K;
    QK, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) at the dtype's peak (bf16: the tensor cores;
    float32: the CUDA cores, where the float32 kernels compute)."""
    e = torch.finfo(dtype).bits // 8
    qb, kvb, st = b * sq * h * d * e, b * sk * hk * d * e, b * h * sq * 4
    nbytes = {"flash_fwd": qb + 2 * kvb + qb + st,                         # q k v → o lse
              "flash_dq": qb + 2 * kvb + 2 * qb + st + qb + st,            # q k v o do lse → dq delta
              "flash_dkv": qb + 2 * kvb + qb + 2 * st + 2 * kvb}           # q k v do lse delta → dk dv
    flops = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}
    out = {}
    for name in nbytes:
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = flops[name] * b * h * d * vis / PEAK_FLOPS[dtype] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def flash_case(shape: str, dtype, causal: bool, sq: int, sk: int, q_offset: int, flush, timed: bool) -> dict:
    g = {**FLASH_SHAPES, **FLASH_ZOO_SHAPES, **FLASH_TP_SHAPES, **FLASH_EDGE_SHAPES}[shape]
    b, h, hk, d = g["b"], g["h"], g["hk"], g["d"]
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + q_offset + int(causal))
    q, do = (torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((b, sk, hk, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    o, lse = flash_fwd_cuda(q, k, v, causal, q_offset)
    dq, delta = flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset)
    dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset)
    want_o, want_lse = flash_fwd_plain(q, k, v, causal, q_offset)
    want_dq, want_dk, want_dv = flash_bwd_plain(q, k, v, o, lse, do, causal, q_offset)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    label = f"{shape} {dtype} causal={causal} Sq={sq} Sk={sk} q_offset={q_offset}"
    # output: (kernel, plain, is a vector per head and row/key)
    outputs = {"flash_fwd": {"o": (o, want_o, True), "lse": (lse, want_lse, False)},
               "flash_dq": {"dq": (dq, want_dq, True), "delta": (delta, flash_delta_plain(o, do), False)},
               "flash_dkv": {"dk": (dk, want_dk, True), "dv": (dv, want_dv, True)}}
    errs, ratios = {}, {}
    for name, outs in outputs.items():
        errs[name] = max(float((got.float() - want.float()).abs().max()) for got, want, _ in outs.values())
        for out, (got, want, vector) in outs.items():
            ratios[out] = tolerance_ratio(got, want, tol, vector)
    log(f"  {label}: |err|/limit " + ", ".join(f"{n}={r:.3g}" for n, r in ratios.items()))
    bad = {n: r for n, r in ratios.items() if not r <= 1}
    if bad:
        raise AssertionError(f"{label}: kernel disagrees with the plain version, |err|/limit {bad}")
    if causal and sk > sq + q_offset and (dk[:, sq + q_offset:].any() or dv[:, sq + q_offset:].any()):
        raise AssertionError(f"{label}: keys above the diagonal got nonzero dk/dv")
    # K2a and K2b sum inside one block in a fixed order, no atomics: a
    # second launch gives the same bits
    dq2, delta2 = flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset)
    if not (torch.equal(dq, dq2) and torch.equal(delta, delta2)):
        raise AssertionError(f"{label}: two K2a launches gave different dq/delta")
    dk2, dv2 = flash_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset)
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"{label}: two K2b launches gave different dk/dv")
    if causal and dtype == torch.bfloat16 and sq == sk:
        mutants = flash_mutants(q, k, v, causal, q_offset, o, lse, dq, dk, dv)
        wants = {out: (want, vector) for outs in outputs.values() for out, (_, want, vector) in outs.items()}
        caught = {n: tolerance_ratio(m, wants[n][0], tol, wants[n][1]) for n, m in mutants.items()}
        log(f"  {label}: faulty kernels' |err|/limit " + ", ".join(f"{n}={r:.3g}" for n, r in caught.items()))
        if not all(r > 1 for r in caught.values()):
            raise AssertionError(f"{label}: the check passes a faulty kernel: {caught}")
    case = f"{shape} {str(dtype)[6:]} {'causal' if causal else 'full'} Sq={sq} Sk={sk} off={q_offset}"
    rows = {k_: {"case": case, "max_abs_err": e_} for k_, e_ in errs.items()}
    if timed:
        vis = visible_keys(sq, sk, causal, q_offset)
        for name, (t, by) in flash_bounds(b, sq, sk, h, hk, d, dtype, vis).items():
            rows[name].update(bound_ms=t, bound_by=by)
        rows["flash_fwd"]["ms"] = time_ms(lambda: flash_fwd_cuda(q, k, v, causal, q_offset), 10, flush)
        rows["flash_dq"]["ms"] = time_ms(lambda: flash_dq_cuda(q, k, v, o, lse, do, causal, q_offset), 10, flush)
        rows["flash_dkv"]["ms"] = time_ms(lambda: flash_dkv_cuda(q, k, v, do, lse, delta, causal, q_offset), 10,
                                          flush)
        rows["flash_fwd"]["plain_ms"] = time_ms(lambda: flash_fwd_plain(q, k, v, causal, q_offset), 3, flush)
        # the plain backward computes dq, dk and dv in one call: its time
        # stands beside both backward kernels
        bwd_ms = time_ms(lambda: flash_bwd_plain(q, k, v, o, lse, do, causal, q_offset), 3, flush)
        rows["flash_dq"]["plain_ms"] = rows["flash_dkv"]["plain_ms"] = bwd_ms
        # library: SDPA on [B, H, S, D] with the GQA heads repeated (not
        # timed); its backward (dq, dk, dv together) by autograd.grad
        rep = h // hk
        qs = q.transpose(1, 2).contiguous().requires_grad_()
        ks, vs = (x.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous().requires_grad_() for x in (k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with torch.no_grad():
            rows["flash_fwd"]["library_ms"] = time_ms(lambda: sdpa(qs, ks, vs, is_causal=causal), 10, flush)
        out = sdpa(qs, ks, vs, is_causal=causal)
        gout = do.transpose(1, 2).contiguous()
        lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), gout, retain_graph=True), 10, flush)
        rows["flash_dq"]["library_ms"] = rows["flash_dkv"]["library_ms"] = lib_bwd
    for name, row in rows.items():
        log(f"  {name} {case}: " + ", ".join(f"{k_}={v_:.4g}" if isinstance(v_, float) else f"{k_}={v_}"
                                             for k_, v_ in row.items() if k_ != "case"))
    return rows


def phase_flash_kernels() -> dict:
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    timed = {}
    for shape, g in FLASH_SHAPES.items():
        s = g["s"]
        timed[shape] = flash_case(shape, torch.bfloat16, True, s, s, 0, flush, timed=True)
        flash_case(shape, torch.bfloat16, False, s, s, 0, flush, timed=False)
        flash_case(shape, torch.float32, True, s, s, 0, flush, timed=False)
        flash_case(shape, torch.float32, False, s, s, 0, flush, timed=False)
        for dtype in (torch.bfloat16, torch.float32):
            flash_case(shape, dtype, True, s // 2, s, s // 2, flush, timed=False)   # queries at an offset
            flash_case(shape, dtype, True, s // 2, s, 0, flush, timed=False)        # keys past the last query
    flash_case("rep3", torch.bfloat16, True, 256, 384, 128, flush, timed=False)
    flash_case("tail", torch.bfloat16, True, 192, 256, 64, flush, timed=False)
    for shape, g in FLASH_ZOO_SHAPES.items():
        s = g["s"]
        timed[shape] = flash_case(shape, torch.bfloat16, True, s, s, 0, flush, timed=True)
        timed[f"{shape} f32"] = flash_case(shape, torch.float32, True, s, s, 0, flush, timed=True)
        flash_case(shape, torch.bfloat16, True, s // 2, s, s // 2, flush, timed=False)   # queries at an offset
    for shape, g in FLASH_TP_SHAPES.items():
        s = g["s"]
        timed[shape] = flash_case(shape, torch.bfloat16, True, s, s, 0, flush, timed=True)
        flash_case(shape, torch.bfloat16, True, s // 2, s, s // 2, flush, timed=False)
    del flush
    torch.cuda.empty_cache()
    return timed


# ---------------------------------------------------------------- phase 26

#: Phi-2's depth in this phase (32 in phase 24; widths kept): an eighth of
#: the blocks, for the script's time
OFFLOAD_PHI2_LAYERS = 4
#: tier b's groups: two staged groups of the state (3 x 4 B a parameter / 10 each)
OFFLOAD_BUFFER_COUNT = 10
OFFLOAD_STAGING_LIMIT = 8e9
OFFLOAD_LLAMA_TIMED = 2


def offload_split(engine, wall_s: float) -> dict:
    """Tier a's step in parts: the forward, backward and norm (the rest of
    the wall), the gradients device -> host, the host optimizer, the new
    parameters host -> device (the tier's own fenced seconds)."""
    split = {k: 1e3 * v for k, v in engine._host_opt.last_split.items()}
    return {"fwd_bwd_ms": 1e3 * wall_s - sum(split.values()),
            "grads_d2h_ms": split["d2h_s"], "host_adam_ms": split["host_opt_s"], "params_h2d_ms": split["h2d_s"]}


def phi_2_offload_run(tier: str, zero: dict, smi: str) -> dict:
    """Phi-2 as phase 24 trains it (published widths, B 2 of S 2048, bf16,
    AdamW, remat ``flash_saveable``, seed 24) at ``OFFLOAD_PHI2_LAYERS``
    blocks: ``plain`` (no offload) two steps, the second timed; tier a one
    timed step, then the loss of the updated weights on the same batch
    (``eval_batch``, the plain run's second loss); tier b one warm step, one
    flushed timed step and one serialized probe (``measure_stream_overlap``'s
    two modes)."""
    hf = ZOO["phi-2"][0]
    cfg = dataclasses.replace(policy_for("phi").build_config(hf), remat=True, remat_policy="flash_saveable",
                              attention_impl="flash", num_hidden_layers=OFFLOAD_PHI2_LAYERS)
    layers = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(24).integers(0, cfg.vocab_size, (ZOO_TRAIN_B, ZOO_TRAIN_S),
                                                              dtype=np.int32)).cuda()
    batch = {"input_ids": ids, "labels": ids}
    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = seed_weights_(training_model(cfg), seed=24)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config={**ZOO_TRAIN_DS_CONFIG, "zero_optimization": zero},
                                                device="cuda")
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in engine.params)
    before = flash_launches()
    report, split = None, None
    if tier in ("plain", "a"):
        losses = [float(engine.train_batch(batch=batch))] if tier == "plain" else []
        acc.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        wall_s = time.perf_counter() - t0
        steps = len(losses)
        if tier == "a":
            split = offload_split(engine, wall_s)
            losses.append(float(engine.eval_batch(batch=batch)))
    else:
        losses = [float(engine.train_batch(batch=batch))]                 # warm
        acc.synchronize()
        t0 = time.perf_counter()
        engine._nvme_step_mode = "flush"
        loss = engine.train_batch(batch=batch)
        engine._nvme_step_mode = None
        acc.synchronize()
        wall_s = time.perf_counter() - t0
        losses.append(float(loss))
        engine._nvme_step_mode = "serialize"
        losses.append(float(engine.train_batch(batch=batch)))
        engine._nvme_step_mode = None
        report = engine._nvme_opt.overlap_report()
        split = {"fwd_bwd_ms": 1e3 * (wall_s - report["pipelined_wall_s"]),
                 "stream_pipeline_ms": 1e3 * report["pipelined_wall_s"],
                 "probe_upload_ms": 1e3 * report["upload_s"], "probe_adam_ms": 1e3 * report["compute_s"],
                 "probe_download_ms": 1e3 * report["download_s"]}
        steps = 3
    launches = tuple(a - b for a, b in zip(flash_launches(), before))
    res = {"tier": tier, "params": n_params, "layers": layers, "build_s": build_s, "step_ms": 1e3 * wall_s,
           "split": split, "tok_s": ZOO_TRAIN_B * ZOO_TRAIN_S / wall_s,
           "peak_mem_gb": acc.max_memory_allocated() / 1e9, "pinned_host_bytes": engine.offload_bytes(),
           "reckoned_state_bytes": 12 * n_params, "losses": losses, "steps": steps,
           "launches": dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), launches)), "card": smi}
    if report is not None:
        res["overlap"] = {k: v for k, v in report.items() if k != "per_group"}
        res["staging_bytes"] = engine._nvme_opt.staging_bytes()
        res["groups"] = engine._nvme_opt.n_groups
    log(f"  Phi-2 ({layers} layers), offload tier {tier}: " + json.dumps(res))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def llama_offload_run(zero: dict, steps: int, batch, state) -> tuple:
    """Llama-125M as phase 6 trains it, under ``zero``: (engine, losses)."""
    engine = build_trainer(llama_125m(), {**BENCH_DS_CONFIG, "zero_optimization": zero}, state=state)
    return engine, [float(engine.train_batch(batch=batch)) for _ in range(steps)]


def state_digest(engine) -> str:
    """sha256 of the master and every optimizer state tensor, in order."""
    h = hashlib.sha256()
    for t in list(engine.master) + [v for st in engine.optimizer.state.values() for v in st.values()
                                    if isinstance(v, torch.Tensor) and v.dim() > 0]:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_offload(smi: str, universal_src: dict) -> dict:
    """The offload tiers (ZeRO-Offload and ZeRO-Infinity) and the universal
    checkpoint on the card: Phi-2 at ``OFFLOAD_PHI2_LAYERS`` blocks without
    offload and through tiers a (host Adam) and b (the host-streamed
    pipeline); Llama-125M through tier c (NVMe swap files
    under a temporary directory: bytes a step, a resume continuing exactly),
    tier d (parameters in host memory at stage 3) against the plain engine,
    ``offload_states``/``reload_states``; phase 15's step-2 checkpoint
    converted to atoms and loaded into a fresh ZeRO-2 engine."""
    t_phase = time.perf_counter()
    res, checks = {"card": smi, "host_memory": host_memory()}, {}
    cfg = llama_125m()
    layers = cfg.num_hidden_layers
    reset_launch_counts()   # the offload path's launches: every run of the phase
    # ---- Phi-2 at OFFLOAD_PHI2_LAYERS blocks: no offload, then tiers a and b
    plain = res["phi2_plain"] = phi_2_offload_run("plain", {"stage": 0}, smi)
    for tier, zero in (("a", {"stage": 0, "offload_optimizer": {"device": "cpu"}}),
                       ("b", {"stage": 0, "offload_optimizer": {"device": "cpu", "pipeline_read": True,
                                                                 "buffer_count": OFFLOAD_BUFFER_COUNT}})):
        run = phi_2_offload_run(tier, zero, smi)
        res[f"phi2_{tier}"] = run
        n = run["params"]
        # tier a: one step and the forward of its eval
        fwd, bwd = (2, 1) if tier == "a" else (3, 3)
        checks[f"phi2_{tier}_k1_k2_once_per_layer_per_step"] = \
            list(run["launches"].values()) == [run["layers"] * k for k in (fwd, bwd, bwd)]
        checks[f"phi2_{tier}_first_loss_is_the_plain_runs"] = run["losses"][0] == plain["losses"][0]
        # the updated weights' loss: tier a's eval, tier b's second step
        checks[f"phi2_{tier}_second_loss_within_bf16"] = abs(run["losses"][1] - plain["losses"][1]) <= \
            1e-2 * abs(plain["losses"][1])
        checks[f"phi2_{tier}_losses_finite"] = bool(np.all(np.isfinite(run["losses"])))
        checks[f"phi2_{tier}_pinned_state_is_12_bytes_a_param"] = run["pinned_host_bytes"]["optimizer"] == 12 * n
        # the device no longer holds the master and the moments (12 B a parameter); tier b
        # stages two groups of them at a time
        staged = run.get("staging_bytes", 0)
        checks[f"phi2_{tier}_peak_below_the_plain_runs"] = \
            run["peak_mem_gb"] < plain["peak_mem_gb"] - (0.8 * 12 * n - staged) / 1e9
    checks["phi2_b_staging_within_limit"] = res["phi2_b"]["staging_bytes"] <= OFFLOAD_STAGING_LIMIT

    ids = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (BENCH_B, BENCH_S),
                                                             dtype=np.int32)).cuda()
    batch = {"input_ids": ids, "labels": ids}
    seed_model = LlamaForCausalLM(cfg, device="cuda")
    init_weights_(seed_model, torch.Generator(device="cuda").manual_seed(26))
    state = {k: v.clone() for k, v in seed_model.state_dict().items()}
    del seed_model

    # ---- Llama-125M: tier c, then a resume on a copy of its swap files
    work = tempfile.mkdtemp(prefix="smoke_nvme_")
    try:
        swap, swap2 = os.path.join(work, "swap"), os.path.join(work, "swap2")
        nvme = {"stage": 2, "offload_optimizer": {"device": "nvme", "nvme_path": swap}}
        t0 = time.perf_counter()
        eng = build_trainer(cfg, {**BENCH_DS_CONFIG, "zero_optimization": nvme}, state=state)
        build_s = time.perf_counter() - t0
        nv = eng._nvme_opt
        losses = [float(eng.train_batch(batch=batch))]
        r0, w0 = nv.bytes_read, nv.bytes_written
        t0 = time.perf_counter()
        for _ in range(OFFLOAD_LLAMA_TIMED):
            loss = eng.train_batch(batch=batch)
        losses.append(float(loss))
        step_s = (time.perf_counter() - t0) / OFFLOAD_LLAMA_TIMED
        n = sum(p.numel() for p in eng.params)
        per_step = {"read": (nv.bytes_read - r0) / OFFLOAD_LLAMA_TIMED,
                    "written": (nv.bytes_written - w0) / OFFLOAD_LLAMA_TIMED}
        eng.save_checkpoint(os.path.join(work, "ckpt"), tag="t")          # flushes the swap files
        shutil.copytree(swap, swap2)
        continued = float(eng.train_batch(batch=batch))
        digest = hashlib.sha256(b"".join(p.detach().float().cpu().numpy().tobytes() for p in eng.params)).hexdigest()
        del eng, nv
        gc.collect()
        resumed = build_trainer(cfg, {**BENCH_DS_CONFIG, "zero_optimization": {
            "stage": 2, "offload_optimizer": {"device": "nvme", "nvme_path": swap2}}}, state=state)
        resumed.load_checkpoint(os.path.join(work, "ckpt"), tag="t", load_optimizer_states=False)
        resumed_loss = float(resumed.train_batch(batch=batch))
        resumed_digest = hashlib.sha256(b"".join(p.detach().float().cpu().numpy().tobytes()
                                                 for p in resumed.params)).hexdigest()
        del resumed
        gc.collect()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["llama_c"] = {"params": n, "build_s": build_s, "step_ms": 1e3 * step_s,
                      "tok_s": BENCH_B * BENCH_S / step_s, "bytes_per_step": per_step,
                      "reckoned_bytes_per_step": 12 * n, "losses": losses, "continued_loss": continued,
                      "resumed_loss": resumed_loss}
    log("  Llama-125M, offload tier c (NVMe): " + json.dumps(res["llama_c"]))
    checks["llama_c_bytes_12_a_param_each_way"] = per_step == {"read": 12 * n, "written": 12 * n}
    checks["llama_c_resume_exact"] = resumed_loss == continued and resumed_digest == digest
    checks["llama_c_losses_finite"] = bool(np.all(np.isfinite(losses)))

    # ---- Llama-125M: tier d at stage 3 against the engine without offload; offload_states
    acc = get_accelerator()
    runs = {}
    for name, zero in (("plain", {"stage": 3}), ("d", {"stage": 3, "offload_param": {"device": "cpu"}})):
        acc.synchronize()
        acc.reset_peak_memory_stats()
        base = acc.memory_allocated()
        eng, losses = llama_offload_run(zero, 2, batch, state)
        runs[name] = {"losses": losses, "peak_mem_gb": (acc.max_memory_allocated() - base) / 1e9,
                      "h2d_copies_per_step": eng.zero.h2d_copies / 2 if eng.zero is not None else None,
                      "host_param_bytes": eng.offload_bytes()["params"]}
        if name == "plain":
            before = state_digest(eng)
            state_bytes = eng.state_bytes()
            acc.synchronize()
            m0 = acc.memory_allocated()
            eng.offload_states(device="cpu")
            acc.synchronize()
            m1 = acc.memory_allocated()
            eng.reload_states()
            runs["offload_states"] = {"device_bytes_before": m0, "device_bytes_offloaded": m1,
                                      "dropped": m0 - m1, "state_bytes": state_bytes["master"] + state_bytes["moments"],
                                      "tensors": 3 * len(eng.master), "bit_for_bit": state_digest(eng) == before}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    res["llama_d"] = runs
    log("  Llama-125M, offload tier d and offload_states: " + json.dumps(runs))
    checks["llama_d_h2d_copies_2L_plus_1_per_step"] = runs["d"]["h2d_copies_per_step"] == 2 * layers + 1
    checks["llama_d_peak_below_no_offload"] = runs["d"]["peak_mem_gb"] < runs["plain"]["peak_mem_gb"]
    checks["llama_d_losses_within_bf16"] = bool(np.allclose(runs["d"]["losses"], runs["plain"]["losses"], rtol=1e-2,
                                                            atol=0))
    os_ = runs["offload_states"]
    # the caching allocator counts whole blocks: a large tensor keeps the rest of its
    # segment when that rest is under 1 MiB, so a little more than the state is freed
    checks["offload_states_frees_the_state"] = os_["state_bytes"] <= os_["dropped"] <= 1.01 * os_["state_bytes"]
    checks["offload_states_bit_for_bit"] = os_["bit_for_bit"]

    # ---- the universal checkpoint: phase 15's step-2 tag as atoms into a fresh ZeRO-2 engine
    from deepspeed_tpu_torch.checkpoint import convert_to_universal, load_universal_checkpoint
    try:
        t0 = time.perf_counter()
        dst = convert_to_universal(os.path.join(universal_src["dir"], "ckpt"), os.path.join(universal_src["dir"],
                                                                                              "universal"),
                                   tag=universal_src["tag"])
        convert_s = time.perf_counter() - t0
        eng = build_trainer(cfg, BENCH_DS_CONFIG, seed=3)
        t0 = time.perf_counter()
        load_universal_checkpoint(eng, dst)
        load_s = time.perf_counter() - t0
        ids3 = torch.from_numpy(universal_src["ids"]).cuda()
        loss = float(eng.train_batch(batch={"input_ids": ids3, "labels": ids3}))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(universal_src["dir"], ignore_errors=True)
    res["universal"] = {"convert_s": convert_s, "load_s": load_s, "next_loss": loss,
                        "resumed_next_loss": universal_src["resumed_loss"]}
    log("  universal checkpoint: " + json.dumps(res["universal"]))
    checks["universal_next_loss_equals_resumed"] = loss == universal_src["resumed_loss"]

    res["launches"] = dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), flash_launches()))
    # Phi-2: 2 + 1 + 3 steps and tier a's eval forward; Llama-125M: tier c 1 + 2 + 1 (continued)
    # + 1 (resumed), tier d and its baseline 2 + 2, the universal engine 1
    steps_125m = 1 + OFFLOAD_LLAMA_TIMED + 2 + 2 + 2 + 1
    phi = OFFLOAD_PHI2_LAYERS
    checks["k1_k2_launches_layers_x_steps"] = list(res["launches"].values()) == \
        [phi * 7 + layers * steps_125m] + [phi * 6 + layers * steps_125m] * 2
    res["checks"] = checks
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  offload checks ({res['phase_s']:.1f} s): " + json.dumps(checks))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"offload phase failed {bad}")
    return res


# ---------------------------------------------------------------- phase 6

BENCH_B, BENCH_S = 24, 1024
BENCH_DS_CONFIG = {"train_batch_size": BENCH_B, "optimizer": {"type": "AdamW",
                                                              "params": {"lr": 1e-4, "weight_decay": 0.01}},
                   "zero_optimization": {"stage": 2}, "bf16": {"enabled": True}, "steps_per_print": 0}


def llama_125m(**overrides) -> LlamaConfig:
    """Llama-125M as the JAX package's bench trains it."""
    fields = dict(max_position_embeddings=BENCH_S, rope_theta=1e4, remat=True, remat_policy="flash_saveable",
                  attention_impl="flash")
    return dataclasses.replace(PRESETS["125m"], **{**fields, **overrides})


def build_trainer(cfg: LlamaConfig, ds_config: dict, seed: int = 0, state=None, device="cuda", **init_kw):
    """``initialize`` over a seeded Llama; returns the engine (``with_loader``
    in ``init_kw``: the engine and the training loader)."""
    with_loader = init_kw.pop("with_loader", False)
    model = LlamaForCausalLM(cfg, device=device)
    if state is None:
        init_weights_(model, torch.Generator(device=device).manual_seed(seed))
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(model=model, config=ds_config, params=state,
                                                          device=device, **init_kw)
    return (engine, loader) if with_loader else engine


def phase_training(smi: str) -> dict:
    cfg = llama_125m()
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (BENCH_B, BENCH_S),
                                                             dtype=np.int32)).cuda()
    batch = {"input_ids": ids, "labels": ids}
    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    engine = build_trainer(cfg, BENCH_DS_CONFIG)
    # phase 27's one-rank reference: the loss of the first TP_TRAIN_ROWS rows before any step
    first_rows_loss = float(engine.eval_batch(batch={k: v[:TP_TRAIN_ROWS] for k, v in batch.items()}))
    reset_launch_counts()
    losses = [float(engine.train_batch(batch=batch)) for _ in range(3)]   # warm-up
    windows, steps_per_window = [], 5
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(steps_per_window):
            loss = engine.train_batch(batch=batch)
        losses.append(float(loss))                                       # the value fetch syncs
        windows.append((time.perf_counter() - t0) / steps_per_window)
    steps = 3 + 2 * steps_per_window
    launches = (flash_fwd_cuda.launches, flash_dq_cuda.launches, flash_dkv_cuda.launches)
    layers = cfg.num_hidden_layers
    if launches != (layers * steps, ) * 3:
        raise AssertionError(f"K1/K2a/K2b launched {launches} times over {steps} steps of {layers} layers: "
                             f"expected {layers} each per step")
    if paged_attention_cuda.launches:
        raise AssertionError("the training path launched the serving kernel K3")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling on a repeated batch: {losses}")
    n_params = sum(p.numel() for p in engine.module.parameters())
    step_s = min(windows)
    tok_s = BENCH_B * BENCH_S / step_s
    # bench.py:160-162: 6N per token plus the attention term
    flops_per_token = 6 * n_params + 12 * layers * cfg.hidden_size * BENCH_S
    res = {"params": n_params, "step_ms": 1e3 * step_s, "window_step_ms": [1e3 * w for w in windows],
           "tok_s": tok_s, "mfu": tok_s * flops_per_token / PEAK_FLOPS[torch.bfloat16],
           "peak_mem_gb": acc.max_memory_allocated() / 1e9, "losses": losses, "steps": steps,
           "launches": dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), launches)),
           "launches_per_step": launches[0] / steps, "card": smi, "first_rows_loss": first_rows_loss}
    log("  training: " + json.dumps(res))
    res["profile"] = profile_training_step(engine, batch)
    del engine
    torch.cuda.empty_cache()
    return res


def profile_training_step(engine, batch) -> dict:
    """One training step under torch.profiler: the device time and the
    kernels that take it; the busy share is that device time over the wall
    time of the next, identical step, not profiled."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(engine.train_batch(batch=batch))
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(engine.train_batch(batch=batch))
    wall_plain = time.perf_counter() - t0
    # device rows only, without the GPU-side span of a user annotation (the
    # optimizer's ``Optimizer.step#...`` region), which would count the
    # kernels inside it twice
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.step#")]
    dev_us = {e.key: e.self_device_time_total for e in rows}
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(((v / 1e3, n) for n, v in dev_us.items() if v > 0), reverse=True)[:10]
    groups = {"flash_fwd": ("flash_fwd_kernel", ), "flash_dq": ("flash_dq_kernel", ),
              "flash_dkv": ("flash_dkv_kernel", ), "gemm": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
              "reduce": ("reduce_kernel", ), "elementwise_copy": ("elementwise", "copy")}
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    for name, us in dev_us.items():
        g = next((g for g, keys in groups.items() if any(k in name for k in keys)), "other")
        by_group[g] += us / 1e3
    # the same device time by the host operator that launched each kernel
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    top_ops = sorted(((e.self_device_time_total / 1e3, e.key, e.count) for e in ops), reverse=True)[:12]
    res = {"wall_ms": 1e3 * wall_plain, "profiled_wall_ms": 1e3 * wall, "device_ms": busy_ms,
           "device_busy_share": busy_ms / (1e3 * wall_plain), "device_ops": sum(e.count for e in rows),
           "device_ms_by_group": by_group, "top_kernels_ms": [[n[:70], t] for t, n in top],
           "top_host_ops_ms_calls": [[n, t, c] for t, n, c in top_ops]}
    log("  training profile: " + json.dumps(res))
    return res


# ---------------------------------------------------------------- phase 7


QKV = ("q_proj", "k_proj", "v_proj")


def run_steps(engine, batches) -> dict:
    """The first batch's gradients of every q/k/v projection, from the
    engine's own forward (the loss ``train_batch`` differentiates), then one
    ``train_batch`` per batch: its loss and its global grad norm (before
    clipping)."""
    params = {n: p for n, p in engine.module.named_parameters() if n.split(".")[-2] in QKV}
    grads = torch.autograd.grad(engine.forward(batches[0]), list(params.values()))
    run = {"grads": {n: g.float() for n, g in zip(params, grads)}, "losses": [], "grad_norms": []}
    for b in batches:
        run["losses"].append(float(engine.train_batch(batch=b)))
        run["grad_norms"].append(engine.get_global_grad_norm())
    return run


def run_differences(a: dict, b: dict) -> dict:
    """How far run ``a`` is from run ``b``: the largest relative difference
    of a per-step loss and of a per-step global grad norm, and per q/k/v
    leaf the relative L2 distance of the first step's gradients."""

    def rel(x, y):
        return max(abs(u - v) / abs(v) for u, v in zip(x, y))

    return {"loss": rel(a["losses"], b["losses"]), "grad_norm": rel(a["grad_norms"], b["grad_norms"]),
            "qkv_grads": {n: float((g - b["grads"][n]).norm() / b["grads"][n].norm()) for n, g in a["grads"].items()}}


def phase_training_parity_f32() -> dict:
    """3 AdamW steps with clipping, float32, 125M width, 2 layers, B 4, S 512:
    the kernel path against the chunked path on the same weights and
    batches.  The two sum in other orders (the f32 kernels on the CUDA
    cores, the chunked path in cuBLAS f32), so losses, global grad norms and
    the first step's q/k/v gradients agree to 1e-5 relative; a K2 that
    scaled dq, dk or dv, or got one head wrong, moves those gradients by
    percents.  Adam's update is about lr·sign(g) where the gradient is
    small, so a parameter whose gradient is below the two paths' rounding
    difference may step by lr either way: all but 1e-4 of the parameters
    within 2e-5, every one within 2·sum(lr)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_125m(num_hidden_layers=2, dtype=torch.float32, max_position_embeddings=512)
    ds_config = {"train_batch_size": 4, "gradient_clipping": 1.0,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}}}
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 512), dtype=np.int32)).cuda()
        batches.append({"input_ids": ids, "labels": ids})
    state = None
    runs, params = {}, {}
    for impl in ("flash", "chunked"):
        eng = build_trainer(dataclasses.replace(cfg, attention_impl=impl), ds_config, seed=1, state=state)
        if state is None:
            state = {k: v.clone() for k, v in eng.module.state_dict().items()}
        runs[impl] = run_steps(eng, batches)
        params[impl] = {k: v.clone() for k, v in eng.module.state_dict().items()}
        del eng
    d = run_differences(runs["flash"], runs["chunked"])
    diff = torch.cat([(params["flash"][k] - params["chunked"][k]).abs().flatten() for k in params["flash"]])
    res = {"losses_kernel": runs["flash"]["losses"], "losses_plain": runs["chunked"]["losses"],
           "grad_norms_kernel": runs["flash"]["grad_norms"], "grad_norms_plain": runs["chunked"]["grad_norms"],
           "kernel_vs_plain": d, "max_param_abs": float(diff.max()),
           "share_param_beyond_2e-5": float((diff > 2e-5).float().mean())}
    log("  f32 training parity (125M width, 2 layers): " + json.dumps(res))
    if not (d["loss"] <= 1e-5 and d["grad_norm"] <= 1e-5 and max(d["qkv_grads"].values()) <= 1e-5
            and res["share_param_beyond_2e-5"] < 1e-4 and res["max_param_abs"] <= 2 * 3e-4):
        raise AssertionError(f"f32 training parity out of tolerance: {res}")
    torch.cuda.empty_cache()
    return res


def phase_training_parity_bf16() -> dict:
    """3 AdamW steps at Llama-3-8B width (2 layers, GQA 32/8, head dim 128,
    vocab 128256), B 1, S 2048: the bf16 kernel path and the bf16 chunked
    path, both held against the chunked path in float32 on the same
    weights.  Tolerance, as phase 4: the plain path's own bf16 error e (per
    measure: the per-step loss, the per-step global grad norm, and per q/k/v
    leaf the first step's gradients); the kernel path must stay within 2·e
    of the plain path and within 1.5·e of float32."""
    cfg = dataclasses.replace(PRESETS["llama3-8b"], num_hidden_layers=2, remat=True, remat_policy="flash_saveable",
                              attention_impl="flash")
    ds_config = {"train_batch_size": 1, "gradient_clipping": 1.0,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-5, "weight_decay": 0.01}}}
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2048), dtype=np.int32)).cuda()
        batches.append({"input_ids": ids, "labels": ids})
    model = LlamaForCausalLM(cfg, device="cuda")
    state = init_weights_(model, torch.Generator(device="cuda").manual_seed(2)).state_dict()
    del model
    configs = {"flash": (cfg, {**ds_config, "bf16": {"enabled": True}}),
               "chunked": (dataclasses.replace(cfg, attention_impl="chunked"),
                           {**ds_config, "bf16": {"enabled": True}}),
               "f32": (dataclasses.replace(cfg, attention_impl="chunked", dtype=torch.float32), ds_config)}
    runs = {}
    for name, (c, dsc) in configs.items():
        reset_launch_counts()
        eng = build_trainer(c, dsc, state=state)
        runs[name] = run_steps(eng, batches)
        if (flash_fwd_cuda.launches > 0) != (name == "flash"):
            raise AssertionError(f"{name}: K1 launched {flash_fwd_cuda.launches} times")
        del eng
        torch.cuda.empty_cache()
    res = {"losses": {n: r["losses"] for n, r in runs.items()},
           "grad_norms": {n: r["grad_norms"] for n, r in runs.items()},
           "kernel_vs_plain": run_differences(runs["flash"], runs["chunked"]),
           "kernel_vs_f32": run_differences(runs["flash"], runs["f32"]),
           "plain_vs_f32": run_differences(runs["chunked"], runs["f32"])}
    log("  bf16 training parity (Llama-3-8B width, 2 layers): " + json.dumps(res))
    e, kp, kf = res["plain_vs_f32"], res["kernel_vs_plain"], res["kernel_vs_f32"]
    within = [kp[m] <= 2 * e[m] and kf[m] <= 1.5 * e[m] for m in ("loss", "grad_norm")]
    within += [kp["qkv_grads"][n] <= 2 * e["qkv_grads"][n] and kf["qkv_grads"][n] <= 1.5 * e["qkv_grads"][n]
               for n in e["qkv_grads"]]
    if not (all(np.isfinite(res["losses"]["flash"])) and all(within)):
        raise AssertionError(f"bf16 training parity out of tolerance: {res}")
    return res


# ---------------------------------------------------------------- phase 15

FEATURE_STEPS = 4                  # the checkpoint run: save after step 2 (sync) and 3 (async)
# Adagrad's first update is lr·sign(g) on every parameter: 1e-2 overshoots at this width
FEATURE_OPTIMIZERS = {"Lamb": {"lr": 1e-2, "weight_decay": 0.01}, "Lion": {"lr": 1e-4, "weight_decay": 0.01},
                      "Adagrad": {"lr": 1e-3}, "SGD": {"lr": 1e-1, "momentum": 0.9}}
FEATURE_PLD = {"enabled": True, "theta": 0.5, "gamma": 0.001}


def feature_dataset(cfg: LlamaConfig, rows: int, seq: int, seed: int = 15) -> list:
    """A seeded token dataset of ``FEATURE_STEPS`` global batches and a short
    tail (dropped by the loader)."""
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (FEATURE_STEPS * rows + rows - 1, seq),
                                               dtype=np.int32)
    return [{"input_ids": r, "labels": r} for r in ids]


class RecordingIter:
    """An iterator that keeps the ``input_ids`` of every batch it hands out."""

    def __init__(self, it):
        self.it, self.seen = it, []

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.it)
        self.seen.append(batch["input_ids"])
        return batch


def state_snapshot(engine) -> dict:
    """Every tensor of the engine's training state, copied to the host."""
    return state_writers.to_host(checkpoint_engine.engine_state(engine))


def snapshot_differences(a, b, where="state") -> list:
    """The paths at which two host state trees differ (tensors bit for bit)."""
    if isinstance(a, torch.Tensor):
        return [] if isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b) else [where]
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [where]
        return [d for k in a for d in snapshot_differences(a[k], b[k], f"{where}.{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [where]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in snapshot_differences(x, y, f"{where}[{i}]")]
    return [] if a == b else [where]


class SaveMeter:
    """Times the phases of ``save_checkpoint`` through instance-free
    wrappers of the state write, the manifest and the whole save (the
    publish is the rest: meta.json, the fence, ``latest``, retention)."""

    def __init__(self):
        self.rows = []

    def save(self, engine, save_dir, tag, cuda: bool):
        times = {"state_s": 0.0, "manifest_s": 0.0}
        saves = {cls: cls.save for cls in (state_writers.CheckpointEngine, state_writers.AsyncCheckpointEngine)}
        manifest = atomic_io.write_manifest

        def timed(key, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    times[key] += time.perf_counter() - t0
            return run

        for cls, fn in saves.items():
            cls.save = timed("state_s", fn)
        atomic_io.write_manifest = timed("manifest_s", manifest)
        try:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.save_checkpoint(save_dir, tag=tag)
            total = time.perf_counter() - t0
        finally:
            for cls, fn in saves.items():
                cls.save = fn
            atomic_io.write_manifest = manifest
        path = os.path.join(save_dir, tag, "state", state_writers.STATE_FILE)
        row = {"tag": tag, "engine": engine._config.checkpoint_config.checkpoint_engine,
               "state_bytes": os.path.getsize(path), "save_s": total, **times,
               "publish_s": total - times["state_s"] - times["manifest_s"]}
        row["save_gb_s"] = row["state_bytes"] / 1e9 / total
        self.rows.append(row)
        return row


def timed_load(engine, load_dir, tag=None, cuda=True) -> dict:
    """``load_checkpoint`` on the host clock, ended by a synchronize."""
    t0 = time.perf_counter()
    path, _ = engine.load_checkpoint(load_dir, tag=tag)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(path, "state", state_writers.STATE_FILE))
    return {"tag": os.path.basename(path), "load_s": seconds, "load_gb_s": nbytes / 1e9 / seconds}


def optimizer_run(cfg, ds_config, batch, steps, device) -> dict:
    """``steps`` steps on one repeated batch: losses, the host step ms
    (each step ended by a synchronize) and the optimizer step's device ms
    (CUDA events around ``optimizer.step``)."""
    engine = build_trainer(cfg, ds_config, device=device)
    cuda = device == "cuda"
    events, step = [], engine.optimizer.step

    def timed_step(*a, **k):
        if not cuda:
            return step(*a, **k)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*a, **k)
        end.record()
        events.append((start, end))
        return out

    engine.optimizer.step = timed_step
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))    # the value fetch syncs
        step_ms.append(1e3 * (time.perf_counter() - t0))
    if cuda:
        torch.cuda.synchronize()
    return {"engine": engine, "losses": losses, "step_ms": step_ms,
            "optimizer_step_ms": [s.elapsed_time(e) for s, e in events]}


def phase_training_features(smi: str, cfg: LlamaConfig = None, rows: int = BENCH_B, seq: int = BENCH_S,
                            device: str = "cuda", keep_step2: bool = False) -> dict:
    """Llama-125M as phase 6 trains it, through the training features of
    ``initialize``: the dataloader, crash-safe checkpoints (sync, async),
    the fallback from a corrupt ``latest``, LAMB/Lion/Adagrad/SGD,
    progressive layer drop, the synchronized timers and the CSV monitor.
    ``device="cpu"`` with a tiny ``cfg`` rehearses it without a card.
    ``keep_step2``: the step-2 checkpoint stays (moved to a directory of its
    own) for phase 26's universal check, which removes it; ``res["universal"]``
    names it with the third batch and the resumed engine's loss on it."""
    cuda = device == "cuda"
    cfg = cfg or llama_125m()
    layers = cfg.num_hidden_layers
    base = {**BENCH_DS_CONFIG, "train_batch_size": rows}
    work = tempfile.mkdtemp(prefix=".smoke_phase15_", dir=os.path.dirname(os.path.abspath(__file__)))
    save_dir = os.path.join(work, "ckpt")
    monitored = {**base, "wall_clock_breakdown": True,
                 "csv_monitor": {"enabled": True, "output_path": os.path.join(work, "csv"), "job_name": "phase15"}}
    data = feature_dataset(cfg, rows, seq)
    res = {"card": smi}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t_phase = time.perf_counter()
    try:
        # ---- the dataloader, the checkpoint run and its control
        engine, loader = build_trainer(cfg, monitored, training_data=data, with_loader=True, device=device)
        if len(loader) != FEATURE_STEPS or loader.batch_size != rows:
            raise AssertionError(f"loader of {len(loader)} batches of {loader.batch_size} rows")
        it = RecordingIter(iter(RepeatingLoader(loader)))
        meter, losses, at_async = SaveMeter(), [], None
        resilience_events.clear()
        for step in range(1, FEATURE_STEPS + 1):
            losses.append(float(engine.train_batch(data_iter=it)))
            if step == 2:
                meter.save(engine, save_dir, "step2", cuda)
            if step == 3:
                engine._config.checkpoint_config.checkpoint_engine = "async"
                at_async = state_snapshot(engine)
                meter.save(engine, save_dir, "step3", cuda)
        order_ok = all(np.array_equal(b, np.stack([d["input_ids"] for d in data[i * rows:(i + 1) * rows]]))
                       for i, b in enumerate(it.seen))
        timer = engine.timers(TRAIN_BATCH_TIMER)
        res.update(loader={"batches": len(loader), "rows": loader.batch_size, "order_ok": order_ok,
                           "batches_taken": len(it.seen)},
                   losses=losses, saves=meter.rows,
                   train_batch_timer_ms=[1e3 * t for t in timer.elapsed_records])
        csv_dir = os.path.join(work, "csv", "phase15")
        res["csv_files"] = sorted(os.listdir(csv_dir))
        res["csv_rows"] = {f: sum(1 for _ in open(os.path.join(csv_dir, f))) - 1 for f in res["csv_files"]}
        resilience_events.attach_monitor(None)
        del engine
        gc.collect()

        control = build_trainer(cfg, base, training_data=data, with_loader=True, device=device)
        it = iter(control[1])
        control_losses = [float(control[0].train_batch(data_iter=it)) for _ in range(FEATURE_STEPS)]
        del control
        gc.collect()
        res["control_losses"] = control_losses
        control_bitwise = control_losses == losses

        resumed = build_trainer(cfg, base, seed=1, device=device)
        res["load_step2"] = timed_load(resumed, save_dir, tag="step2", cuda=cuda)
        it = iter(RepeatingLoader(DeepSpeedDataLoader(data, rows)))
        next(it), next(it)
        res["resumed_losses"] = [float(resumed.train_batch(data_iter=it)) for _ in range(FEATURE_STEPS - 2)]
        del resumed
        gc.collect()

        def rel(a, b):
            return max(abs(x - y) / abs(y) for x, y in zip(a, b))

        res["control_rel_diff"] = rel(control_losses, losses)
        res["resumed_rel_diff"] = rel(res["resumed_losses"], losses[2:])
        # the control's criterion: bit-identical if the control is, else
        # within twice the control's own run-to-run difference
        resume_ok = res["resumed_losses"] == losses[2:] if control_bitwise else \
            res["resumed_rel_diff"] <= 2 * res["control_rel_diff"]
        res["control_bitwise"] = control_bitwise

        # ---- the async tag against the host copy taken at its save; the fallback
        loaded = build_trainer(cfg, base, seed=2, device=device)
        res["load_step3"] = timed_load(loaded, save_dir, tag="step3", cuda=cuda)
        async_diff = snapshot_differences(state_snapshot(loaded), at_async)
        broken = os.path.join(work, "broken")
        shutil.copytree(save_dir, broken, copy_function=os.link)   # hard links: no bytes copied
        os.remove(os.path.join(broken, "latest"))
        with open(os.path.join(broken, "latest"), "w") as f:
            f.write("no_such_tag")
        resilience_events.clear()
        res["fallback"] = timed_load(loaded, broken, cuda=cuda)
        res["fallback"]["events"] = sorted({e[0] for e in resilience_events.recent("resilience/")})
        del loaded
        gc.collect()

        # ---- the new optimizers
        ids = torch.from_numpy(np.stack([d["input_ids"] for d in data[:rows]])).to(device)
        batch = {"input_ids": ids, "labels": ids}
        res["optimizers"] = {}
        for name, params in FEATURE_OPTIMIZERS.items():
            before = (flash_fwd_cuda.launches, flash_dq_cuda.launches, flash_dkv_cuda.launches)
            run = optimizer_run(cfg, {**base, "optimizer": {"type": name, "params": params}}, batch, 3, device)
            after = (flash_fwd_cuda.launches, flash_dq_cuda.launches, flash_dkv_cuda.launches)
            run["optimizer"] = type(run.pop("engine").optimizer).__name__
            run["launches_per_step"] = [(a - b) / 3 for a, b in zip(after, before)]
            res["optimizers"][name] = run
            gc.collect()

        # ---- progressive layer drop
        run = build_trainer(cfg, {**base, "progressive_layer_drop": FEATURE_PLD}, device=device)
        pld = {"theta": [], "mask": [], "losses": []}
        before = (flash_fwd_cuda.launches, flash_dq_cuda.launches, flash_dkv_cuda.launches)
        for _ in range(3):
            pld["losses"].append(float(run.train_batch(batch=batch)))
            pld["mask"].append(run._pld_scale.tolist())
            pld["theta"].append(run.progressive_layer_drop.get_theta())
        after = (flash_fwd_cuda.launches, flash_dq_cuda.launches, flash_dkv_cuda.launches)
        pld["launches_per_step"] = [(a - b) / 3 for a, b in zip(after, before)]
        res["pld"] = pld
        del run
        gc.collect()
    finally:
        resilience_events.attach_monitor(None)
        kept = None
        if keep_step2 and os.path.isdir(save_dir):
            kept = tempfile.mkdtemp(prefix=".smoke_phase15_step2_", dir=os.path.dirname(work))
            os.rename(save_dir, os.path.join(kept, "ckpt"))
        shutil.rmtree(work, ignore_errors=True)
    res["launches"] = dict(zip(("flash_fwd", "flash_dq", "flash_dkv"),
                               (flash_fwd_cuda.launches, flash_dq_cuda.launches, flash_dkv_cuda.launches)))
    res["phase_s"] = time.perf_counter() - t_phase
    if cuda:
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
    log("  training features: " + json.dumps(res))

    # ---- the checks
    steps = FEATURE_STEPS * 2 + 2 + 3 * len(FEATURE_OPTIMIZERS) + 3   # A, control, resumed, optimizers, PLD
    checks = {
        "loader_order": res["loader"]["order_ok"] and res["loader"]["batches_taken"] == FEATURE_STEPS,
        "losses_finite": all(np.isfinite(losses + control_losses + res["resumed_losses"] + pld["losses"])),
        "resume_equals_uninterrupted": resume_ok,
        "async_tag_equals_state_at_save": not async_diff,
        "fallback_to_newest_valid": res["fallback"]["tag"] == "step3"
        and "resilience/ckpt_fallback" in res["fallback"]["events"],
        "optimizers_finite": all(np.isfinite(r["losses"]).all() for r in res["optimizers"].values()),
        "optimizers_falling": all(r["losses"][-1] < r["losses"][0] for r in res["optimizers"].values()),
        "pld_theta": pld["theta"] == [(1 - 0.5) * float(np.exp(-0.001 * s)) + 0.5 for s in (1, 2, 3)],
        "pld_masks": all(len(m) == layers for m in pld["mask"]),
        "timer_records": len(res["train_batch_timer_ms"]) == FEATURE_STEPS,
        "csv_monitor": {"Train_Samples_train_loss.csv", "resilience_ckpt_published.csv"} <= set(res["csv_files"])
        and res["csv_rows"]["Train_Samples_train_loss.csv"] == FEATURE_STEPS,
        "ckpt_events_published": res["csv_rows"].get("resilience_ckpt_published.csv") == 2,
    }
    if cuda:
        checks["k1_k2_once_per_layer_per_step"] = \
            all(r["launches_per_step"] == [layers] * 3 for r in res["optimizers"].values()) \
            and pld["launches_per_step"] == [layers] * 3 \
            and list(res["launches"].values()) == [layers * steps] * 3
        checks["k3_not_launched"] = paged_attention_cuda.launches == 0
    res["checks"] = checks
    log("  training features checks: " + json.dumps(checks))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 15 failed {failed}: async diff {async_diff[:5]}")
    if kept is not None:
        third = np.stack([d["input_ids"] for d in data[2 * rows:3 * rows]])
        res["universal"] = {"dir": kept, "tag": "step2", "ids": third, "resumed_loss": res["resumed_losses"][0]}
    return res


# ---------------------------------------------------------------- phase 8

# BERT-large's attention (deepspeed_tpu/models/bert.py: 16 heads of 64) at a
# 4096-token context (its 512 learned positions tiled by
# extend_position_embedding), bf16
SPARSE_B, SPARSE_H, SPARSE_S, SPARSE_D, SPARSE_BLOCK = 4, 16, 4096, 64, 16
#: the ``sparse_attention`` block of DeepSpeed's config documentation
#: (config-json, "Sparse Attention")
DOC_SPARSE_ATTENTION = {"mode": "fixed", "block": 16, "different_layout_per_head": True, "num_local_blocks": 4,
                        "num_global_blocks": 1, "attention": "bidirectional", "horizontal_global_attention": False,
                        "num_different_global_patterns": 4}
SPARSE_NAMES = ("sparse_attn_fwd", "sparse_attn_dq", "sparse_attn_dkv")


def sparse_configs(h: int, block: int) -> dict:
    """name → (sparsity config, causal) of the layouts phase 8 checks."""
    return {
        "fixed": (make_sparsity_config({**DOC_SPARSE_ATTENTION, "block": block}, num_heads=h), False),
        "fixed_uni": (FixedSparsityConfig(h, block, True, num_local_blocks=4, num_global_blocks=1,
                                          attention="unidirectional", num_different_global_patterns=4), True),
        "bigbird": (BigBirdSparsityConfig(h, block, True, num_random_blocks=1, num_sliding_window_blocks=3,
                                          num_global_blocks=1), False),
        "bslongformer": (BSLongformerSparsityConfig(h, block, True, num_sliding_window_blocks=3,
                                                    global_block_indices=[0]), False),
        "variable": (VariableSparsityConfig(h, block, True, num_random_blocks=1, local_window_blocks=[2, 4],
                                            global_block_indices=[0]), False),
        "local": (LocalSlidingWindowSparsityConfig(h, block, num_sliding_window_blocks=3), True),
        "dense": (DenseSparsityConfig(h, block), False),
    }


def sparse_inputs(b, h, s, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype) for _ in range(4)]


def sparse_kernels(q, k, v, do, tables, block, causal, kpm=None) -> dict:
    """K6a, then K6b and K6c from its outputs."""
    o, lse = sparse_attn_fwd_cuda(q, k, v, tables, block, causal, None, kpm)
    dq, delta = sparse_attn_dq_cuda(q, k, v, o, lse, do, tables, block, causal, None, kpm)
    dk, dv = sparse_attn_dkv_cuda(q, k, v, do, lse, delta, tables, block, causal, None, kpm)
    return {"o": o, "lse": lse, "dq": dq, "delta": delta, "dk": dk, "dv": dv}


def sparse_plain(q, k, v, do, got, tables, block, causal, kpm=None) -> dict:
    """The plain versions on the same inputs; the backward from the kernel's
    o and lse, as K6b and K6c take them."""
    o, lse = sparse_attn_fwd_plain(q, k, v, tables, block, causal, None, kpm)
    dq, dk, dv = sparse_attn_bwd_plain(q, k, v, got["o"], got["lse"], do, tables, block, causal, None, kpm)
    return {"o": o, "lse": lse, "dq": dq, "delta": sparse_attn_delta_plain(got["o"], do), "dk": dk, "dv": dv}


def sparse_ratio(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    """``tolerance_ratio`` of one output; lse is held on the rows that attend
    to a key, and must read exactly 3e38 on the others."""
    if name in ("lse", "delta"):
        live = want != EMPTY_ROW_LSE
        if not torch.equal(got[~live], want[~live]):
            return float("inf")
        return tolerance_ratio(got[live], want[live], tol, vector=False) if bool(live.any()) else 0.0
    return tolerance_ratio(got, want, tol, vector=True)


def sparse_mutants(q, k, v, layout, block, causal, kpm, got, tables) -> dict:
    """Faulty kernels the check must reject, made from the kernel's outputs,
    as name → (output, faulty tensor): K6a that drops the first admitted kv
    block of the first row block (of head 0) that admits two; K6b that zeroes
    that row block's dq; K6c that zeroes dk and dv of head 0's widest column
    (a global column where the layout has one); and, where a column group
    holds two blocks or more, K6c that loses the dk of its second member."""
    counts = layout[0].sum(-1)
    r = int(np.argmax(counts >= 2))
    cut = layout[:1].copy()
    cut[0, r, np.nonzero(layout[0, r])[0][0]] = 0
    o_cut, lse_cut = sparse_attn_fwd_plain(q[:, :1], k[:, :1], v[:, :1], build_tables(cut, block, "cuda"), block,
                                           causal, None, kpm)
    rows = slice(r * block, (r + 1) * block)
    out = {n: got[n].clone() for n in ("o", "lse", "dq", "dk", "dv")}
    out["o"][:, 0, rows], out["lse"][:, 0, rows] = o_cut[:, 0, rows], lse_cut[:, 0, rows]
    out["dq"][:, 0, rows] = 0
    c = int(np.argmax(layout[0].sum(-2)))
    out["dk"][:, 0, c * block:(c + 1) * block] = 0
    out["dv"][:, 0, c * block:(c + 1) * block] = 0
    faulty = {n: (n, t) for n, t in out.items()}
    groups = tables.col_groups.cpu().numpy()
    multi = groups[(groups >= 0).sum(1) >= 2]
    if len(multi):
        h, blk = divmod(int(multi[0, 1]), layout.shape[1])
        dk = got["dk"].clone()
        dk[:, h, blk * block:(blk + 1) * block] = 0
        faulty["dk_group_member"] = ("dk", dk)
    return faulty


def sparse_case(label, cfg, causal, b, s, d, dtype, kpm=None, mutants=True, empty_rows=False) -> dict:
    """Hold K6a/K6b/K6c to their plain versions on one layout; with
    ``mutants``, fail unless the check rejects each faulty kernel.  A row
    with no visible key must get exactly 0 in o (and 3e38 in lse, see
    ``sparse_ratio``); with ``empty_rows`` the case must have such rows.
    Returns per kernel the largest |kernel − plain|."""
    h, block = cfg.num_heads, cfg.block
    layout = np.asarray(cfg.make_layout(s))
    tables = build_tables(layout, block, "cuda")
    q, k, v, do = sparse_inputs(b, h, s, d, dtype, seed=s + d + block + int(causal))
    got = sparse_kernels(q, k, v, do, tables, block, causal, kpm)
    want = sparse_plain(q, k, v, do, got, tables, block, causal, kpm)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    ratios = {n: sparse_ratio(n, got[n], want[n], tol) for n in got}
    log(f"  {label}: density {layout.mean():.4f}, |err|/limit " + ", ".join(f"{n}={r:.3g}" for n, r in ratios.items()))
    bad = {n: r for n, r in ratios.items() if not r <= 1}
    if bad:
        raise AssertionError(f"{label}: kernel disagrees with the plain version, |err|/limit {bad}")
    empty = want["lse"] == EMPTY_ROW_LSE
    if bool(got["o"][empty].any()):
        raise AssertionError(f"{label}: a row with no visible key got a nonzero o")
    if empty_rows and not bool(empty.any()):
        raise AssertionError(f"{label}: the case has no row without a visible key")
    # a kv block no row admits gets zero dk/dv
    dead_cols = torch.from_numpy(layout.sum(-2) == 0).cuda().repeat_interleave(block, dim=1)   # [H, S]
    if bool(dead_cols.any()) and (got["dk"][:, dead_cols].any() or got["dv"][:, dead_cols].any()):
        raise AssertionError(f"{label}: a kv block no row admits got nonzero dk/dv")
    # a second launch of K6b and K6c gives bit-identical dq, delta, dk and dv
    again = sparse_attn_dq_cuda(q, k, v, got["o"], got["lse"], do, tables, block, causal, None, kpm)
    again += sparse_attn_dkv_cuda(q, k, v, do, got["lse"], got["delta"], tables, block, causal, None, kpm)
    torch.cuda.synchronize()
    if not all(torch.equal(a, got[n]) for a, n in zip(again, ("dq", "delta", "dk", "dv"))):
        raise AssertionError(f"{label}: two launches of K6b/K6c differ")
    if mutants:
        faulty = sparse_mutants(q, k, v, layout, block, causal, kpm, got, tables)
        caught = {n: sparse_ratio(out, m, want[out], tol) for n, (out, m) in faulty.items()}
        log(f"  {label}: faulty kernels' |err|/limit " + ", ".join(f"{n}={r:.3g}" for n, r in caught.items()))
        if not all(r > 1 for r in caught.values()):
            raise AssertionError(f"{label}: the check passes a faulty kernel: {caught}")
    outs = {"sparse_attn_fwd": ("o", "lse"), "sparse_attn_dq": ("dq", "delta"), "sparse_attn_dkv": ("dk", "dv")}
    return {kname: max(float((got[n].float() - want[n].float()).abs().max()) for n in names)
            for kname, names in outs.items()}


def visible_pairs(layout: np.ndarray, block: int, causal: bool) -> int:
    """(query, key) token pairs the layout lets attend, per batch row: a whole
    block for an admitted block, its lower triangle on the diagonal and
    nothing above it with causal."""
    if not causal:
        return int(layout.astype(bool).sum()) * block * block
    h, r, c = np.nonzero(layout)
    return int((c < r).sum()) * block * block + int((c == r).sum()) * block * (block + 1) // 2


def sparse_bounds(layout, block, b, d, causal, tables, dtype) -> dict:
    """Least time of each kernel: each input read once (the index tables
    included) and each output written once, against 4/6/8·D flops per
    visible pair (QK+PV; QK, dO·Vᵀ, dS·K; QK, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) at the
    bf16 tensor-core peak."""
    h, nb, _ = layout.shape
    x = b * h * nb * block * d * (torch.finfo(dtype).bits // 8)      # one [B, H, S, D] tensor
    st = b * h * nb * block * 4                                        # one [B, H, S] f32 statistic
    def table_bytes(*ts):
        return 4 * sum(t.numel() for t in ts)

    rows = table_bytes(tables.row_ptr, tables.row_idx, tables.row_order)
    # the bf16 K6b and K6c read the group tables in place of the order tables
    row_groups = table_bytes(tables.row_ptr, tables.row_idx, tables.row_groups, tables.row_group_order)
    col_groups = table_bytes(tables.col_ptr, tables.col_idx, tables.col_groups, tables.col_group_order)
    nbytes = {"sparse_attn_fwd": 3 * x + rows + x + st,                # q k v → o lse
              "sparse_attn_dq": 5 * x + st + row_groups + x + st,      # q k v o do lse → dq delta
              "sparse_attn_dkv": 4 * x + 2 * st + col_groups + 2 * x}  # q k v do lse delta → dk dv
    pairs = b * visible_pairs(layout, block, causal)
    out = {}
    for name, per_pair in zip(SPARSE_NAMES, (4, 6, 8)):
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = per_pair * d * pairs / PEAK_FLOPS[torch.bfloat16] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def sparse_timing(label, cfg, causal, flush, plain=True, library=True, tables=None) -> dict:
    """Kernel (cold L2), plain and library time of K6a/K6b/K6c at the full
    configuration, beside each kernel's bound."""
    b, s, d, dtype = SPARSE_B, SPARSE_S, SPARSE_D, torch.bfloat16
    block = cfg.block
    layout = np.asarray(cfg.make_layout(s))
    tables = tables if tables is not None else build_tables(layout, block, "cuda")
    q, k, v, do = sparse_inputs(b, cfg.num_heads, s, d, dtype, seed=1)
    got = sparse_kernels(q, k, v, do, tables, block, causal)
    rows = {n: {"case": label, "density": float(layout.mean())} for n in SPARSE_NAMES}
    for name, (t, by) in sparse_bounds(layout, block, b, d, causal, tables, dtype).items():
        rows[name].update(bound_ms=t, bound_by=by)
    rows["sparse_attn_fwd"]["ms"] = time_ms(lambda: sparse_attn_fwd_cuda(q, k, v, tables, block, causal), 10, flush)
    rows["sparse_attn_dq"]["ms"] = time_ms(
        lambda: sparse_attn_dq_cuda(q, k, v, got["o"], got["lse"], do, tables, block, causal), 10, flush)
    rows["sparse_attn_dkv"]["ms"] = time_ms(
        lambda: sparse_attn_dkv_cuda(q, k, v, do, got["lse"], got["delta"], tables, block, causal), 10, flush)
    if plain:
        rows["sparse_attn_fwd"]["plain_ms"] = time_ms(
            lambda: sparse_attn_fwd_plain(q, k, v, tables, block, causal), 3, flush)
        # the plain backward computes dq, dk and dv in one call: its time
        # stands beside both backward kernels
        bwd_ms = time_ms(lambda: sparse_attn_bwd_plain(q, k, v, got["o"], got["lse"], do, tables, block, causal), 3,
                         flush)
        rows["sparse_attn_dq"]["plain_ms"] = rows["sparse_attn_dkv"]["plain_ms"] = bwd_ms
    if library:
        # SDPA on the same [B, H, S, D] tensors with the layout expanded to a
        # boolean token mask [1, H, S, S] (built outside the timing); its
        # backward (dq, dk, dv together) by autograd.grad
        mask = torch.from_numpy(layout != 0).cuda().repeat_interleave(block, 1).repeat_interleave(block, 2)
        if causal:
            mask &= torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with torch.no_grad():
            rows["sparse_attn_fwd"]["library_ms"] = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask[None]), 10, flush)
        out = sdpa(qs, ks, vs, attn_mask=mask[None])
        lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True), 10, flush)
        rows["sparse_attn_dq"]["library_ms"] = rows["sparse_attn_dkv"]["library_ms"] = lib_bwd
        del mask, out
    for name, row in rows.items():
        log(f"  {name} {label}: " + ", ".join(f"{k_}={v_:.4g}" if isinstance(v_, float) else f"{k_}={v_}"
                                             for k_, v_ in row.items() if k_ != "case"))
    return rows


def phase_sparse_kernels() -> dict:
    b, h, s, d = SPARSE_B, SPARSE_H, SPARSE_S, SPARSE_D
    errs = {n: 0.0 for n in SPARSE_NAMES}

    def check(*args, **kwargs):
        for n, e in sparse_case(*args, **kwargs).items():
            errs[n] = max(errs[n], e)

    # the documented example's groups: the 4 rows of a local window admit one
    # list, as do the 3 plain columns of a window and a head's 64 global columns
    t = build_tables(sparse_configs(h, SPARSE_BLOCK)["fixed"][0].make_layout(s), SPARSE_BLOCK, "cuda")
    groups = {"row_groups": t.row_groups.shape[0], "col_groups": t.col_groups.shape[0],
              "row_blocks": t.row_order.numel()}
    log(f"  fixed S{s} block {SPARSE_BLOCK}: CTAs of the bf16 K6b/K6c per batch row " + json.dumps(groups))
    if (groups["row_groups"], groups["col_groups"]) != (1024, 1280):
        raise AssertionError(f"fixed layout groups {groups}, expected 1024 row and 1280 column groups")
    for name, (cfg, causal) in sparse_configs(h, SPARSE_BLOCK).items():
        check(f"{name} bf16 B{b} S{s} D{d} block {SPARSE_BLOCK}", cfg, causal, b, s, d, torch.bfloat16)
    # padded sequences: the last 10% of batch row 1's keys and a scattered 5% of row 3's
    kpm = torch.ones((b, s), dtype=torch.bool, device="cuda")
    kpm[1, -s // 10:] = False
    kpm[3] = torch.rand(s, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda") > 0.05
    for name in ("fixed", "fixed_uni"):
        cfg, causal = sparse_configs(h, SPARSE_BLOCK)[name]
        check(f"{name} bf16 key_padding_mask", cfg, causal, b, s, d, torch.bfloat16, kpm=kpm)
    # rows with no visible key: kpm masks batch row 2 whole and keys 1024..2047
    # of row 0, which hold every key the local window admits to the rows of
    # blocks 65..127
    kpm_empty = torch.ones((b, s), dtype=torch.bool, device="cuda")
    kpm_empty[2] = False
    kpm_empty[0, 1024:2048] = False
    cfg, causal = sparse_configs(h, SPARSE_BLOCK)["local"]
    check("local bf16 key_padding_mask, rows with no visible key", cfg, causal, b, s, d, torch.bfloat16,
          kpm=kpm_empty, empty_rows=True)
    for name, (cfg, causal) in sparse_configs(h, SPARSE_BLOCK).items():
        check(f"{name} f32 S1024", cfg, causal, b, 1024, d, torch.float32, mutants=False)
    for dtype in (torch.bfloat16, torch.float32):
        for name in ("fixed", "fixed_uni"):
            cfg, causal = sparse_configs(h, 64)[name]
            check(f"{name} {str(dtype)[6:]} D128 block 64", cfg, causal, b, s, 128, dtype,
                  mutants=dtype == torch.bfloat16)
    # K6a's tiles of 2 and 4 warps: block 32, and block 128 (two sub-tiles of 64)
    for block in (32, 128):
        cfg, causal = sparse_configs(h, block)["fixed_uni"]
        check(f"fixed_uni bf16 D128 block {block}", cfg, causal, b, s, 128, torch.bfloat16)
    log(f"  max |kernel - plain|: " + json.dumps(errs))

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    timed = {}
    for name in ("fixed", "bigbird"):
        cfg, causal = sparse_configs(h, SPARSE_BLOCK)[name]
        timed[name] = sparse_timing(name, cfg, causal, flush)
    # the straggler: BSLongformer's global row and column admit all 256
    # blocks, a local window of the same density admits at most 5; both
    # launched heaviest first, and BSLongformer also in table order
    straggler = {}
    cfg_g, _ = sparse_configs(h, SPARSE_BLOCK)["bslongformer"]
    cfg_l = LocalSlidingWindowSparsityConfig(h, SPARSE_BLOCK, num_sliding_window_blocks=5, attention="bidirectional")
    straggler["bslongformer"] = sparse_timing("bslongformer", cfg_g, False, flush, plain=False, library=False)
    straggler["local5"] = sparse_timing("local5", cfg_l, False, flush, plain=False, library=False)
    t = build_tables(cfg_g.make_layout(s), SPARSE_BLOCK, "cuda")

    def natural(order):
        return torch.arange(order.numel(), dtype=torch.int32, device="cuda")

    straggler["bslongformer_table_order"] = sparse_timing(
        "bslongformer table order", cfg_g, False, flush, plain=False, library=False,
        tables=dataclasses.replace(t, row_order=natural(t.row_order), col_order=natural(t.col_order),
                                   row_group_order=natural(t.row_group_order),
                                   col_group_order=natural(t.col_group_order)))
    share = {n: 1 - straggler["local5"][n]["ms"] / straggler["bslongformer"][n]["ms"] for n in SPARSE_NAMES}
    log("  straggler share (1 - local5 / bslongformer): " + json.dumps(share))
    del flush
    torch.cuda.empty_cache()
    return {"errs": errs, "timed": timed, "straggler": straggler, "straggler_share": share, "groups": groups}


# ---------------------------------------------------------------- phase 9


def phase_sparse_path(smi: str) -> dict:
    """The sparse path through its entry points, as a user would call it:
    the DeepSpeed config's ``sparse_attention`` block → a sparsity config →
    ``SparseSelfAttention`` forward and backward on CUDA tensors.  Each
    iteration's wall time ends in a synchronize; the first one also builds
    the layout, its index tables and the ops' dispatch state."""
    b, h, s, d = SPARSE_B, SPARSE_H, SPARSE_S, SPARSE_D
    ds_config = DeepSpeedConfig({"train_batch_size": b, "bf16": {"enabled": True},
                                 "sparse_attention": dict(DOC_SPARSE_ATTENTION)})
    sparsity = make_sparsity_config(ds_config.sparse_attention, num_heads=h)
    attn = SparseSelfAttention(sparsity)
    # BERT-large's 512 learned positions tiled to the 4096-token context
    pos = extend_position_embedding(torch.randn((512, h * d), device="cuda", dtype=torch.bfloat16), s)
    if tuple(pos.shape) != (s, h * d) or not torch.equal(pos[512:1024], pos[:512]):
        raise AssertionError(f"extend_position_embedding gave {tuple(pos.shape)}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    do = torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    iters, walls = 3, []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = attn(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), do)
        acc.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    launches = {n: fn.launches for n, fn in zip(SPARSE_NAMES, (sparse_attn_fwd_cuda, sparse_attn_dq_cuda,
                                                                sparse_attn_dkv_cuda))}
    if list(launches.values()) != [iters] * 3:
        raise AssertionError(f"K6a/K6b/K6c launched {launches} times over {iters} forward and backward calls")
    if any(fn.launches for fn in (paged_attention_cuda, flash_fwd_cuda, flash_dq_cuda, flash_dkv_cuda)):
        raise AssertionError("the sparse path launched a dense attention kernel")
    if tuple(out.shape) != (b, h, s, d) or not all(bool(torch.isfinite(t).all()) for t in (out, *grads)):
        raise AssertionError("the sparse path gave non-finite outputs or gradients")
    # the path's outputs against the plain versions on the same inputs
    tables = attn.get_sparse_layout(s).tables("cuda")
    want_o, _ = sparse_attn_fwd_plain(q.detach(), k.detach(), v.detach(), tables, sparsity.block)
    o, lse = sparse_attn_fwd_cuda(q.detach(), k.detach(), v.detach(), tables, sparsity.block)
    want_grads = sparse_attn_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse, do, tables, sparsity.block)
    tol = FLASH_TOL[torch.bfloat16]
    ratios = {n: tolerance_ratio(g, w, tol, vector=True)
              for n, g, w in zip(("o", "dq", "dk", "dv"), (out.detach(), *grads), (want_o, *want_grads))}
    if not all(r <= 1 for r in ratios.values()):
        raise AssertionError(f"the sparse path disagrees with the plain versions: |err|/limit {ratios}")
    res = {"config": ds_config.sparse_attention, "shape": [b, h, s, d], "density": float(attn.get_layout(s).mean()),
           "launches": launches, "iters": iters, "wall_ms_per_iter": walls, "ratios": ratios,
           "peak_mem_gb": acc.max_memory_allocated() / 1e9, "card": smi}
    log("  sparse path: " + json.dumps(res))
    res["profile"] = profile_sparse_iteration(attn, q, k, v, do)
    return res


def launch_events(fn):
    """Run ``fn`` with a pair of CUDA events recorded on the launch stream
    around every K6a/K6b/K6c launch (the wrappers' ``_launch``): returns
    ``fn``'s result and [(kernel, start, end)] in launch order, to be read
    after a synchronize."""
    from deepspeed_tpu_torch.ops.sparse_attention import kernel as sk
    marks, launch = [], sk._launch

    def timed(name, f, q, *args):
        stream = torch.cuda.current_stream(q.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        launch(name, f, q, *args)
        end.record(stream)
        marks.append((name.replace("_cuda", ""), start, end))

    sk._launch = timed
    try:
        return fn(), marks
    finally:
        sk._launch = launch


def profile_sparse_iteration(attn, q, k, v, do) -> dict:
    """One forward and backward, its kernels timed in the path: each K6a,
    K6b and K6c launch between two CUDA events on its stream, and the span
    from the iteration's first event to its last.  The busy share is the
    kernels' device time over the wall time of the next, identical
    iteration.  torch.profiler, over a third iteration, adds the device time
    by kernel where it records device events (as the third profiler session
    of the whole script it records none)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    _, marks = launch_events(lambda: torch.autograd.grad(attn(q, k, v), (q, k, v), do))
    torch.cuda.synchronize()
    kernel_ms = {n: s_.elapsed_time(e) for n, s_, e in marks}
    if sorted(kernel_ms) != sorted(SPARSE_NAMES) or len(marks) != 3:
        raise AssertionError(f"one iteration launched {[m[0] for m in marks]}, expected one each of {SPARSE_NAMES}")
    span_ms = marks[0][1].elapsed_time(marks[-1][2])
    t0 = time.perf_counter()
    torch.autograd.grad(attn(q, k, v), (q, k, v), do)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(attn(q, k, v), (q, k, v), do)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(((e.self_device_time_total / 1e3, e.key) for e in rows if e.self_device_time_total > 0),
                 reverse=True)[:6]
    res = {"kernel_ms": kernel_ms, "kernels_ms": sum(kernel_ms.values()), "device_span_ms": span_ms,
           "wall_ms": wall_ms, "device_busy_share": sum(kernel_ms.values()) / wall_ms,
           "profiler_device_ops": sum(e.count for e in rows), "profiler_top_kernels_ms": [[n[:70], t] for t, n in top]}
    log("  sparse path profile: " + json.dumps(res))
    return res


# ---------------------------------------------------------------- phase 10

QUANT_N = 32000 * 768     # the embedding (and lm_head) of Llama-125M: its largest gradient
QUANT_BLOCK = 256
QUANT_NAMES = ("quantize_int8", "dequantize_int8", "quantize_int4", "dequantize_int4")
QUANT_REPLACES = {"quantize_int8": "deepspeed_tpu/ops/quant_kernels.py:31",
                  "dequantize_int8": "deepspeed_tpu/ops/quant_kernels.py:39",
                  "quantize_int4": "deepspeed_tpu/ops/quant_kernels.py:44",
                  "dequantize_int4": "deepspeed_tpu/ops/quant_kernels.py:56"}


def quant_input(n: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """Gradient-like values in blocks of 256 at scales 1e-6..1e2, block 1 all
    zero, block 2 x/scale ties for int8 (absmax 127: scale exactly 1) and
    block 3 for int4 (absmax 7)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nb = n // QUANT_BLOCK
    scale = 10.0**(torch.rand((nb, 1), generator=gen, device="cuda") * 8 - 6)
    x = torch.randn((nb, QUANT_BLOCK), generator=gen, device="cuda") * scale
    x[1] = 0
    j = torch.arange(QUANT_BLOCK, device="cuda")
    sign = 1 - 2 * (j % 2)
    for row, qmax in ((2, 127), (3, 7)):
        x[row] = (j % qmax + 0.5) * sign
        x[row, 0] = qmax
    return x.reshape(-1).to(dtype)


def quant_check(label: str, x: torch.Tensor, route: str, block: int = QUANT_BLOCK) -> dict:
    """The four kernels on ``x`` against their plain versions on the same
    CUDA tensors: codes, scales and dequantized values must be identical,
    and K5a's launch must have taken ``route`` (``Q4_ROUTES``).  The
    dequantize kernels run at the shape the W=2 wire gives them,
    [2·nb/2, block] into [2, n/2].  Returns per kernel the largest
    |kernel − plain| (0 when they agree)."""
    n = x.numel()
    out = {}
    routes = dict(quantize_int4_cuda.routes)
    for bits, quant, dequant in ((8, quantize_int8_cuda, dequantize_int8_cuda),
                                 (4, quantize_int4_cuda, dequantize_int4_cuda)):
        pq, pd = (quantize_int8_plain, dequantize_int8_plain) if bits == 8 else (quantize_int4_plain,
                                                                                 dequantize_int4_plain)
        q, s = quant(x, block)
        want_q, want_s = pq(x, block)
        shape = (2, n // 2) if n % (2 * block) == 0 else (n, )
        deq = dequant(q, s, shape)
        want_deq = pd(q, s, shape)
        torch.cuda.synchronize()
        same = torch.equal(q, want_q) and torch.equal(s, want_s) and torch.equal(deq, want_deq)
        out[f"quantize_int{bits}"] = max(float((q.int() - want_q.int()).abs().max()), float((s - want_s).abs().max()))
        out[f"dequantize_int{bits}"] = float((deq - want_deq).abs().max())
        if not same or not bool(torch.isfinite(deq).all()):
            raise AssertionError(f"{label}: int{bits} kernels differ from the plain versions: {out}")
    took = [k for k, v in quantize_int4_cuda.routes.items() if v != routes[k]]
    if took != [route]:
        raise AssertionError(f"{label}: K5a took {took}, expected {route}")
    log(f"  {label}: n {n}, block {block}, codes, scales and dequantized values identical to the plain versions; "
        f"K5a took {route}")
    return out


def quant_mutants(x: torch.Tensor) -> dict:
    """Faulty kernels the check must reject, made from the kernels' outputs:
    K4a that rounds x/scale half away from zero, K5a that swaps the halves of
    its bytes (element i in the high nibble, i + 128 in the low), and K5a
    that packs element i with element i + 4, the next lane's, in place of
    i + 128."""
    q8, s8 = quantize_int8_cuda(x, QUANT_BLOCK)
    r = x.float().reshape(-1, QUANT_BLOCK) / s8[:, None]
    away = torch.clamp(torch.sign(r) * torch.floor(r.abs() + 0.5), -127, 127).to(torch.int8)
    q4, _ = quantize_int4_cuda(x, QUANT_BLOCK)
    swapped = (q4 >> 4) | (q4 << 4)
    codes = torch.cat([q4 & 0xF, q4 >> 4], dim=1)   # code + 8 of each element, in order
    half = QUANT_BLOCK // 2
    neighbour = codes[:, :half] | (codes[:, 4:half + 4] << 4)
    want8, _ = quantize_int8_plain(x, QUANT_BLOCK)
    want4, _ = quantize_int4_plain(x, QUANT_BLOCK)
    torch.cuda.synchronize()
    caught = {"round_half_away": not torch.equal(away, want8), "int4_halves_swapped": not torch.equal(swapped, want4),
              "int4_packs_lane_neighbour": not torch.equal(neighbour, want4),
              "codes_off_by_round_half_away": int((away != want8).sum()),
              "bytes_off_by_swap": int((swapped != want4).sum()),
              "bytes_off_by_neighbour": int((neighbour != want4).sum())}
    log(f"  faulty kernels: {json.dumps(caught)}")
    if not (caught["round_half_away"] and caught["int4_halves_swapped"] and caught["int4_packs_lane_neighbour"]):
        raise AssertionError(f"the check passes a faulty quant kernel: {caught}")
    return caught


def quant_bounds(n: int, in_bytes: int) -> dict:
    """Least time of each kernel at n elements: its input read once and its
    output written once at the HBM rate (a few operations per element: all
    four are bound by bytes)."""
    scales = 4 * (n // QUANT_BLOCK)
    nbytes = {"quantize_int8": in_bytes * n + n + scales, "dequantize_int8": n + scales + 4 * n,
              "quantize_int4": in_bytes * n + n // 2 + scales, "dequantize_int4": n // 2 + scales + 4 * n}
    return {k: (v / HBM_BYTES_PER_S * 1e3, "bytes") for k, v in nbytes.items()}


def llama_125m_wire_shapes() -> list:
    """The shapes of Llama-125M's 111 gradients as the qgZ wire carries them
    (the engine's order; ``nn.Linear`` weights transposed)."""
    model = LlamaForCausalLM(llama_125m(), device="meta")
    linear = {id(m.weight) for m in model.modules() if isinstance(m, torch.nn.Linear)}
    return [tuple(p.t().shape) if id(p) in linear else tuple(p.shape) for p in model.parameters()
            if p.is_floating_point()]


def grouped_step_bounds(table: SegmentTable, in_bytes: int) -> dict:
    """Least time of one qgZ step's grouped launches: K4a over the step's
    tensors (``in_bytes`` an element, unpadded: the padding is not read) and
    over the f32 shards; K4b over the received copies (identity) and the
    gathered codes (into f32 tensors, cut).  Each input read once, each
    output written once, at the HBM rate."""
    rows, shard_rows, b = table.rows, table.chunk, table.block
    k4a = in_bytes * table.total + rows * (b + 4) + shard_rows * (4 * b + b + 4)
    k4b = rows * (b + 4) + 4 * rows * b + rows * (b + 4) + 4 * table.total
    return {"quantize_int8": k4a / HBM_BYTES_PER_S * 1e3, "dequantize_int8": k4b / HBM_BYTES_PER_S * 1e3}


def grouped_mutants(x, table, q, s, through) -> dict:
    """Faulty grouped kernels the check must reject: K4a that ignores each
    tensor's end (a block past n_t reads the next tensor's elements, not
    zeros: the real kernel fed a table whose counts are the padded ones, over
    an input with room behind it), and K4b that writes rank 1's chunk where
    rank 0's belongs (the real kernel fed the code rows with the two chunks
    swapped)."""
    want_q, want_s = quantize_int8_grouped_plain(x, table)
    want_out = dequantize_int8_grouped_plain(want_q, want_s, table, through)
    ignore_ends = copy.copy(table)
    records, row_segments = table.device_tables(x.device)
    records = records.clone()
    records[:, 0] = torch.tensor([c * table.world * table.block for c in table.chunk_rows], device=x.device)
    ignore_ends._on_device = {x.device: (records, row_segments)}
    roomy = torch.cat([x, torch.zeros(table.world * table.block, dtype=x.dtype, device=x.device)])[:table.total]
    bad_q, bad_s = quantize_int8_cuda(roomy, table.block, ignore_ends)
    c = table.chunk
    swapped = dequantize_int8_cuda(torch.cat([q[c:2 * c], q[:c], q[2 * c:]]),
                                   torch.cat([s[c:2 * c], s[:c], s[2 * c:]]), (table.total, ), table, through)
    torch.cuda.synchronize()
    caught = {"k4a_ignores_tensor_ends": not (torch.equal(bad_q, want_q) and torch.equal(bad_s, want_s)),
              "k4b_rank_chunks_swapped": not torch.equal(swapped, want_out),
              "rows_off_by_ignored_ends": int((bad_q != want_q).any(dim=1).sum()),
              "values_off_by_swap": int((swapped != want_out).sum())}
    log(f"  faulty grouped kernels: {json.dumps(caught)}")
    if not (caught["k4a_ignores_tensor_ends"] and caught["k4b_rank_chunks_swapped"]):
        raise AssertionError(f"the check passes a faulty grouped quant kernel: {caught}")
    return caught


def quant_step(flush) -> dict:
    """One qgZ step's grouped launches on the step's real table (the 111
    Llama-125M gradients at W 2, bf16 input as the bench configuration sends
    them): the send buffer (K4a), the received copies (K4b, identity), the
    f32 shards (K4a, identity) and the gathered tensors (K4b, through bf16),
    each bit-identical to its plain version; two faulty grouped kernels;
    per-step device ms (each launch cold) beside the per-step bound."""
    table = SegmentTable([int(np.prod(s)) for s in llama_125m_wire_shapes()], DP_WORLD, QUANT_BLOCK)
    x = quant_input(table.rows * QUANT_BLOCK, torch.float32, seed=14)[:table.total]
    x = x.to(torch.bfloat16)
    q, s = quantize_int8_cuda(x, QUANT_BLOCK, table)
    received = (DP_WORLD, table.chunk * QUANT_BLOCK)
    recv = dequantize_int8_cuda(q, s, received)
    reduced = recv.sum(dim=0) / torch.full_like(recv[0], DP_WORLD)
    q2, s2 = quantize_int8_cuda(reduced, QUANT_BLOCK)
    out = dequantize_int8_cuda(q, s, (table.total, ), table, torch.bfloat16)
    torch.cuda.synchronize()
    want_q, want_s = quantize_int8_grouped_plain(x, table)
    want_q2, want_s2 = quantize_int8_plain(reduced, QUANT_BLOCK)
    same = {"send": torch.equal(q, want_q) and torch.equal(s, want_s),
            "received": torch.equal(recv, dequantize_int8_plain(want_q, want_s, received)),
            "shards": torch.equal(q2, want_q2) and torch.equal(s2, want_s2),
            "gathered": torch.equal(out, dequantize_int8_grouped_plain(want_q, want_s, table, torch.bfloat16))}
    if not all(same.values()) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"grouped quant kernels differ from their plain versions on the step's table: {same}")
    log(f"  step table: {len(table)} tensors, {table.total} elements, {table.rows} code rows (chunk {table.chunk}); "
        f"grouped K4a/K4b identical to the plain versions: {json.dumps(same)}")
    mutants = grouped_mutants(x, table, q, s, torch.bfloat16)
    launches = {"k4a_send": lambda: quantize_int8_cuda(x, QUANT_BLOCK, table),
                "k4b_received": lambda: dequantize_int8_cuda(q, s, received),
                "k4a_shards": lambda: quantize_int8_cuda(reduced, QUANT_BLOCK),
                "k4b_gathered": lambda: dequantize_int8_cuda(q, s, (table.total, ), table, torch.bfloat16)}
    ms = {k: time_ms(fn, 10, flush) for k, fn in launches.items()}
    bounds = grouped_step_bounds(table, 2)
    step = {"quantize_int8": ms["k4a_send"] + ms["k4a_shards"],
            "dequantize_int8": ms["k4b_received"] + ms["k4b_gathered"]}
    res = {"tensors": len(table), "elements": table.total, "rows": table.rows, "launch_ms": ms, "step_ms": step,
           "step_bound_ms": bounds, "step_bound_ms_f32_input": grouped_step_bounds(table, 4),
           "codec_ms": sum(ms.values()), "codec_bound_ms": sum(bounds.values()), "mutants": mutants}
    log("  grouped step: " + json.dumps({k: v for k, v in res.items() if k != "mutants"}))
    return res


def phase_quant_kernels() -> dict:
    """K4a/K4b/K5a/K5b against their plain versions at the wire's shapes:
    the embedding's 24,576,000 elements in f32 and bf16, a 768-element norm
    weight padded to 1024, an nb (1001) that is not a multiple of the 8
    blocks of a CTA, the embedding in f32 as a view one element into its
    storage (K5a's ``q4_kernel_any``), and blocks of 64 (``q4_kernel_any``);
    three faulty kernels must be rejected; kernel / plain time (cold L2) at
    the embedding's shape beside the bound, and K5a's in bf16 and on the
    misaligned view; then the grouped K4a/K4b on one qgZ step's real table
    (``quant_step``)."""
    x = quant_input(QUANT_N, torch.float32, seed=10)
    x_bf16 = quant_input(QUANT_N, torch.bfloat16, seed=11)
    x_odd = torch.cat([torch.zeros(1, device="cuda"), x])[1:]
    fast, other = Q4_ROUTES
    errs = quant_check("embedding f32", x, fast)
    for label, t, route, block in (
            ("embedding bf16", x_bf16, fast, QUANT_BLOCK),
            ("norm 768 padded to 1024", torch.cat([quant_input(1024, torch.float32, seed=12)[:768],
                                                   torch.zeros(256, device="cuda")]), fast, QUANT_BLOCK),
            ("nb 1001", quant_input(1001 * QUANT_BLOCK, torch.float32, seed=13), fast, QUANT_BLOCK),
            ("embedding f32 misaligned by one element", x_odd, other, QUANT_BLOCK),
            ("nb 1001 at block 64", quant_input(1001 * QUANT_BLOCK, torch.float32, seed=15), other, 64)):
        for k, v in quant_check(label, t, route, block).items():
            errs[k] = max(errs[k], v)
    mutants = quant_mutants(x)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    q8, s8 = quantize_int8_cuda(x, QUANT_BLOCK)
    q4, s4 = quantize_int4_cuda(x, QUANT_BLOCK)
    shape = (2, QUANT_N // 2)
    timed = {
        "quantize_int8": (lambda: quantize_int8_cuda(x, QUANT_BLOCK), lambda: quantize_int8_plain(x, QUANT_BLOCK)),
        "dequantize_int8": (lambda: dequantize_int8_cuda(q8, s8, shape), lambda: dequantize_int8_plain(q8, s8, shape)),
        "quantize_int4": (lambda: quantize_int4_cuda(x, QUANT_BLOCK), lambda: quantize_int4_plain(x, QUANT_BLOCK)),
        "dequantize_int4": (lambda: dequantize_int4_cuda(q4, s4, shape), lambda: dequantize_int4_plain(q4, s4, shape)),
    }
    rows = {}
    for name, (t_bound, by) in quant_bounds(QUANT_N, 4).items():
        kernel, plain = timed[name]
        rows[name] = {"case": f"f32 n={QUANT_N}", "max_abs_err": errs[name], "ms": time_ms(kernel, 20, flush),
                      "plain_ms": time_ms(plain, 5, flush), "bound_ms": t_bound, "bound_by": by, "library_ms": None}
    # K5a on bf16 input (q4_kernel_256) and on the misaligned f32 view (q4_kernel_any)
    rows["quantize_int4"].update(
        bf16_ms=time_ms(lambda: quantize_int4_cuda(x_bf16, QUANT_BLOCK), 20, flush),
        bf16_plain_ms=time_ms(lambda: quantize_int4_plain(x_bf16, QUANT_BLOCK), 5, flush),
        bf16_bound_ms=quant_bounds(QUANT_N, 2)["quantize_int4"][0],
        misaligned_ms=time_ms(lambda: quantize_int4_cuda(x_odd, QUANT_BLOCK), 20, flush))
    for name, row in rows.items():
        log(f"  {name}: " + ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
    step = quant_step(flush)
    del flush
    torch.cuda.empty_cache()
    return {"rows": rows, "mutants": mutants, "step": step}


# ---------------------------------------------------------------- phase 11

DP_WORLD = 2
DP_TIMEOUT_S = 600
DP_WARMUP, DP_TIMED, DP_LOCO_STEPS, DP_CONTROL_STEPS = 3, 5, 3, 5
DP_DS_CONFIG = {**BENCH_DS_CONFIG, "zero_optimization": {"stage": 0, "zero_quantized_gradients": True}}
QUANT_COUNTERS = (quantize_int8_cuda, dequantize_int8_cuda, quantize_int4_cuda, dequantize_int4_cuda)


def quant_replay_ms(numels, rank: int) -> dict:
    """Ms of one qgZ step's exchange on this card, host issue included (CUDA
    events around 3 calls, no spin ahead of them), with its collectives
    replaced by device copies of the same sizes (the rank's own codes stand
    in for what it would receive), timed while the other rank waits at a
    barrier (two ranks' CUDA contexts time-slice the card, so events inside
    the shared step would count the other rank's work too), for both routes
    over the step's gradients in bf16, as the engine feeds them:
      * ``per_tensor``: ``padded_quant_allreduce`` of each tensor (the
        engine's route before the grouped exchange), 444 launches of K4a/K4b;
      * ``grouped``: ``GroupedQuantAllreduce``, the engine's exchange, 4."""
    from unittest import mock

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.comm import GroupedQuantAllreduce, padded_quant_allreduce
    xs = [torch.randn(n, device="cuda").to(torch.bfloat16) for n in numels]
    wire = GroupedQuantAllreduce([(n, ) for n in numels], torch.bfloat16, "cuda")
    routes = (("per_tensor", lambda: [padded_quant_allreduce(x) for x in xs]), ("grouped", lambda: wire(xs)))

    def all_to_all(out, t, group=None):
        return out.copy_(t)

    def all_gather(out, t, group=None):
        out.view(DP_WORLD, *t.shape).copy_(t)
        return out

    ms = {}
    for turn in range(DP_WORLD):
        comm.barrier()
        if turn == rank:
            with mock.patch.object(comm, "all_to_all_single", all_to_all), \
                    mock.patch.object(comm, "all_gather_into_tensor", all_gather):
                for name, step in routes:
                    step()
                    torch.cuda.synchronize()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(3):
                        step()
                    end.record()
                    end.synchronize()
                    ms[name] = start.elapsed_time(end) / 3
    comm.barrier()
    return ms


def param_digest(engine) -> str:
    """sha256 over every parameter's and master tensor's bytes."""
    h = hashlib.sha256()
    for t in [p.detach() for p in engine.module.parameters()] + list(engine.master):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_batch():
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, PRESETS["125m"].vocab_size, (BENCH_B, BENCH_S),
                                                             dtype=np.int32)).cuda()
    return {"input_ids": ids, "labels": ids}


def dp_train(ds_config: dict, steps: int, timed_from=None) -> dict:
    """A fresh engine on this rank (seeded weights, broadcast from rank 0) and
    ``steps`` train_batch calls on the repeated global batch; the steps from
    ``timed_from`` on are timed as one window ended by a fetch of the loss.
    ``collectives``: the calls of each collective over the steps."""
    from deepspeed_tpu_torch.comm import comm
    engine = build_trainer(llama_125m(), ds_config)
    batch = dp_batch()
    calls = comm.call_counts.copy()
    losses = []
    for i in range(steps):
        if i == timed_from:
            float(losses[-1])
            wire0 = {k: list(v) for k, v in comm.comms_logger().comms_dict["all_to_all_quant_reduce"].items()}
            t0 = time.perf_counter()
        losses.append(engine.train_batch(batch=batch))
    float(losses[-1])                    # the value fetch ends the window
    res = {"engine": engine, "losses": [float(l) for l in losses], "collectives": dict(comm.call_counts - calls)}
    if timed_from is not None:
        n = steps - timed_from
        window_s = time.perf_counter() - t0
        wire1 = comm.comms_logger().comms_dict["all_to_all_quant_reduce"]
        wire_s = sum(v[1] for v in wire1.values()) - sum(v[1] for v in wire0.values())
        res.update(step_ms=1e3 * window_s / n, wire_ms_per_step=1e3 * wire_s / n)
    return res


def dp_rank(rank: int) -> dict:
    """Phase 11 on one rank: qgZ steps (3 warm-up, 5 timed), LoCo steps, the
    float32-wire control, and the int4 collectives over the embedding's
    gradient against their plain versions on CPU copies."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.comm import all_to_all_quant_reduce, padded_quant_allreduce, quantized_all_gather
    comm.configure(enabled=True)
    acc = get_accelerator()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    run = dp_train(DP_DS_CONFIG, DP_WARMUP + DP_TIMED, timed_from=DP_WARMUP)
    launches = {f.__name__: f.launches for f in LAUNCH_COUNTERS}
    engine = run.pop("engine")
    res = {"qgz": run, "launches": launches, "numels": [p.numel() for p in engine.params], "qgz_active": engine.qgz,
           "wire_bytes": engine._compressed_wire_bytes,
           "comms": {str(k): v[0] for k, v in comm.comms_logger().comms_dict["all_to_all_quant_reduce"].items()},
           "digest": param_digest(engine), "peak_mem_gb": acc.max_memory_allocated() / 1e9,
           "backend": comm.get_backend()}
    res["qgz"]["codec_ms_per_step"] = quant_replay_ms(res["numels"], rank)
    # one step's gradients of this rank's rows: the grouped exchange against
    # the per-tensor route, and the embedding's for the int4 calls
    rows = {k: v[rank * BENCH_B // DP_WORLD:(rank + 1) * BENCH_B // DP_WORLD] for k, v in dp_batch().items()}
    grads = torch.autograd.grad(engine.forward(rows), engine.params)
    wire = [engine._to_wire(g.float(), t) for g, t in zip(grads, engine._wire_transposed)]
    grouped = engine._wire(wire)
    per_tensor = [padded_quant_allreduce(g.to(engine.compute_dtype)).float() for g in wire]
    res["grouped_equals_per_tensor"] = all(torch.equal(a, b) for a, b in zip(grouped, per_tensor))
    grad = grads[[id(p) for p in engine.params].index(id(engine.module.embed_tokens.weight))].float()
    del engine, grads, wire, grouped, per_tensor
    torch.cuda.empty_cache()

    for counter in QUANT_COUNTERS:
        counter.launches = 0
    quantize_int4_cuda.routes = dict.fromkeys(Q4_ROUTES, 0)
    shard = all_to_all_quant_reduce(grad, bits=4)
    full = quantized_all_gather(shard, bits=4)
    torch.cuda.synchronize()
    res["int4_launches"] = {f.__name__: f.launches for f in (quantize_int4_cuda, dequantize_int4_cuda)}
    res["int4_routes"] = dict(quantize_int4_cuda.routes)
    shard_cpu = all_to_all_quant_reduce(grad.cpu(), bits=4)
    full_cpu = quantized_all_gather(shard_cpu, bits=4)
    res["int4_identical"] = torch.equal(shard.cpu(), shard_cpu) and torch.equal(full.cpu(), full_cpu)
    del grad, shard, full

    loco_cfg = {**DP_DS_CONFIG, "zero_optimization": {**DP_DS_CONFIG["zero_optimization"],
                                                      "zeropp_loco_param": {"err_beta": 0.8}}}
    for counter in QUANT_COUNTERS:
        counter.launches = 0
    loco = dp_train(loco_cfg, DP_LOCO_STEPS)
    loco["launches"] = {f.__name__: f.launches for f in (quantize_int8_cuda, dequantize_int8_cuda)}
    engine = loco.pop("engine")
    res["loco"] = {**loco, "error_abs_max": max(float(e.abs().max()) for e in engine.loco_error),
                   "digest": param_digest(engine)}
    del engine
    torch.cuda.empty_cache()
    control = dp_train({**DP_DS_CONFIG, "zero_optimization": {"stage": 0}}, DP_CONTROL_STEPS)
    engine = control.pop("engine")
    res["control"] = {**control, "digest": param_digest(engine), "qgz_active": engine.qgz}
    del engine
    torch.cuda.empty_cache()
    return res


def dp_rank_main(rank: int, init_method: str, queue, tp_inputs=None) -> None:
    """A spawned rank: both ranks share the one card (cuda:0) over gloo.
    After phase 11's work the two ranks serve phase 27(a) over tensor 2
    (with ``tp_inputs``, the zoo's directories and the v1 engine's
    reference, its dense zoo and v1 runs too)."""
    from deepspeed_tpu_torch.comm import comm
    try:
        torch.cuda.set_device(0)
        comm.init_distributed(dist_backend="gloo", init_method=init_method, rank=rank, world_size=DP_WORLD,
                              timeout=DP_TIMEOUT_S, verbose=False)
        out = dp_rank(rank)
        gc.collect()
        torch.cuda.empty_cache()
        out["tp"] = {"bf16": tp_serve_bf16(), "f32": tp_serve_f32()}
        out["tp_qwen"] = {"bf16": tp_serve_bf16(lambda: qwen_rank_engine(QWEN_MOE, torch.bfloat16, TP_QWEN_SEED,
                                                                         1024)),
                          "f32": tp_serve_f32(lambda: qwen_whole_engine(qwen_f32_hf(), torch.float32,
                                                                        TP_QWEN_F32_SEED, 256))}
        if tp_inputs is not None:
            out["tp_zoo"] = tp_zoo_rank(tp_inputs)
        out["done_at"] = time.time()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if comm.is_initialized():
            torch.distributed.destroy_process_group()


def phase_data_parallel(smi: str, tp_inputs=None) -> dict:
    """The data-parallel path through its entry points: two ranks on the one
    card (spawned; gloo: NCCL refuses two ranks on one card), each
    ``initialize`` → ``train_batch`` on Llama-125M at full width and depth
    with ``zero_quantized_gradients`` (qgZ), 12 of the 24 rows per rank;
    then phase 27(a) on the same ranks (``tp_inputs``: ``tp_zoo_rank``'s)."""
    import multiprocessing
    import socket
    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=dp_rank_main, args=(r, f"tcp://127.0.0.1:{port}", queue, tp_inputs))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    ranks = {}
    try:
        for _ in range(DP_WORLD):
            rank, res, err = queue.get(timeout=DP_TIMEOUT_S)
            if err is not None:
                raise AssertionError(f"data-parallel rank {rank} failed:\n{err}")
            ranks[rank] = res
        received = time.time()
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"data-parallel ranks exited with {[p.exitcode for p in procs]}")
    done = max(r["done_at"] for r in ranks.values())
    log(f"  phase 11 + 27(a) ranks: results handed over {received - done:.2f} s after the last rank's work, "
        f"the ranks exited {time.time() - received:.2f} s after that")
    r0, r1 = ranks[0], ranks[1]
    steps = DP_WARMUP + DP_TIMED
    layers = PRESETS["125m"].num_hidden_layers
    n_tensors = len(r0["numels"])
    unit = DP_WORLD * 256     # JAX engine.py:1016-1026: per direction the padded int8 payload and its scales
    want_bytes = sum(2 * (n + 4 * (n // 256)) for n in (-(-m // unit) * unit for m in r0["numels"]))
    checks = {
        "qgz_active": r0["qgz_active"] and r1["qgz_active"] and not r0["control"]["qgz_active"],
        "backend_gloo": r0["backend"] == "gloo",
        "k4a_k4b_2_per_step": all(
            r["launches"]["quantize_int8_cuda"] == r["launches"]["dequantize_int8_cuda"] == 2 * steps
            for r in (r0, r1)),
        "wire_4_collectives_per_step": all(
            r["qgz"]["collectives"] == {"all_to_all_single": 2 * steps, "all_gather_into_tensor": 2 * steps,
                                        "all_reduce": 2 * steps} for r in (r0, r1)),
        "grouped_equals_per_tensor": r0["grouped_equals_per_tensor"] and r1["grouped_equals_per_tensor"],
        "k1_k2_once_per_layer": all(r["launches"][k] == layers * steps for r in (r0, r1)
                                    for k in ("flash_fwd_cuda", "flash_dq_cuda", "flash_dkv_cuda")),
        "k5_launched": all(r["int4_launches"] == {"quantize_int4_cuda": 2, "dequantize_int4_cuda": 2}
                           for r in (r0, r1)),
        "k5a_took_q4_kernel_256": all(r["int4_routes"] == {"q4_kernel_256": 2, "q4_kernel_any": 0} for r in (r0, r1)),
        "int4_identical_to_plain": r0["int4_identical"] and r1["int4_identical"],
        "losses_finite_falling": all(np.isfinite(r0["qgz"]["losses"])) and
        r0["qgz"]["losses"][-1] < r0["qgz"]["losses"][0],
        "ranks_bit_identical": r0["digest"] == r1["digest"] and r0["loco"]["digest"] == r1["loco"]["digest"]
        and r0["control"]["digest"] == r1["control"]["digest"],
        "losses_equal_on_ranks": r0["qgz"]["losses"] == r1["qgz"]["losses"],
        "comms_bytes_formula": r0["wire_bytes"] == want_bytes and list(r0["comms"]) == [str(want_bytes)],
        "loco_error_nonzero": r0["loco"]["error_abs_max"] > 0,
        "loco_k4a_2_k4b_3_per_step": all(r["loco"]["launches"] == {"quantize_int8_cuda": 2 * DP_LOCO_STEPS,
                                                                   "dequantize_int8_cuda": 3 * DP_LOCO_STEPS}
                                         for r in (r0, r1)),
        "qgz_within_5e-2_of_fp32_wire": bool(np.allclose(r0["qgz"]["losses"][:DP_CONTROL_STEPS],
                                                         r0["control"]["losses"], rtol=5e-2, atol=5e-2)),
    }
    q = r0["qgz"]
    res = {"card": smi, "backend": r0["backend"], "ranks_on_one_card": DP_WORLD,
           "payload_path": "CUDA tensors handed to gloo (gloo copies them through host memory itself)",
           "n_tensors": n_tensors, "step_ms": [r["qgz"]["step_ms"] for r in (r0, r1)],
           "tok_s_both_ranks": BENCH_B * BENCH_S / (max(r["qgz"]["step_ms"] for r in (r0, r1)) / 1e3),
           "wire_ms_per_step": [r["qgz"]["wire_ms_per_step"] for r in (r0, r1)],
           "codec_ms_per_step_alone": [r["qgz"]["codec_ms_per_step"] for r in (r0, r1)],
           "collectives": r0["qgz"]["collectives"], "loco_collectives": r0["loco"]["collectives"],
           "peak_mem_gb": [r["peak_mem_gb"] for r in (r0, r1)], "wire_bytes_per_step": r0["wire_bytes"],
           "losses_qgz": q["losses"], "losses_fp32_wire": r0["control"]["losses"], "losses_loco": r0["loco"]["losses"],
           "loco_error_abs_max": r0["loco"]["error_abs_max"], "launches": r0["launches"],
           "int4_launches": r0["int4_launches"], "int4_routes": r0["int4_routes"], "checks": checks}
    log("  data parallel: " + json.dumps(res))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"data-parallel phase failed {bad}")
    res["tp_ranks"] = [ranks[r]["tp"] for r in range(DP_WORLD)]   # phase 27(a)'s, checked by its phase
    res["tp_qwen_ranks"] = [ranks[r]["tp_qwen"] for r in range(DP_WORLD)]
    res["tp_zoo_ranks"] = [ranks[r].get("tp_zoo") for r in range(DP_WORLD)]
    return res


# ---------------------------------------------------------------- phase 25

#: world → the ZeRO stages trained over it in bf16 at full depth (stage 3 at W = 4: 32000 % 3 != 0; W = 4's
#: stage 3 is held to W = 3's stage 0) and in float32 at 2 layers (each world's stage 0 the reference)
ZERO_RUNS = {3: (0, 1, 2), 4: (3, )}
ZERO_PARITY_RUNS = {3: (0, 1, 2), 4: (0, 3)}
# one warm-up step, one timed (two timed steps took the whole script past ~520 s)
ZERO_STEPS, ZERO_TIMED_FROM = 2, 1
#: the order in which each world times the two reduce-scatter routes (alternated across worlds)
ZERO_RS_ORDER = {4: ("native", "all_to_all"), 3: ("all_to_all", "native")}
ZERO_PARITY_LAYERS, ZERO_PARITY_STEPS = 2, 2
ZERO_TIMEOUT_S = 600
FLASH_COUNTERS = (flash_fwd_cuda, flash_dq_cuda, flash_dkv_cuda)
# phase 25's expert-parallel run at W = 4 (data 2 × expert 2, ZeRO-2, bf16): Mixtral-8x7B's widths at one
# layer, one row of EP_S a rank, one untimed step then one timed (a step takes ~7 s, the gloo wire
# 96% of it); and the float32 parity of expert 2 against expert 1 at 2 layers of a narrow width
EP_SIZE, EP_LAYERS, EP_S = 2, 1, 1024
EP_STEPS, EP_TIMED_FROM = 2, 1
EP_PARITY = MixtralConfig(vocab_size=32000, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                          num_attention_heads=8, num_key_value_heads=2, max_position_embeddings=256,
                          num_local_experts=8, num_experts_per_tok=2, capacity_factor=1.0, dtype=torch.float32,
                          remat=True, remat_policy="flash_saveable")
EP_PARITY_S, EP_PARITY_STEPS = 256, 3
# the same run over expert 2 × tensor 2 (W = 4, data 1): the same 4 rows, 2 a data rank; and its float32
# parity at EP_PARITY in 2 micro-batches of one row a data rank (gas 2), so that each gating group is one row
# as at data 2 × expert 2
ETP_TP, ETP_GAS = 2, 2
#: a rank's parameters of Mixtral-8x7B's widths at one layer over expert 2 × tensor 2 (4 experts at half of
#: expert_mlp, attention and vocab halved, router and norms whole), of the whole model's
ETP_RANK_PARAMS, ETP_WHOLE_PARAMS = 504_410_112, 1_713_418_240
#: the first bf16 loss of expert 2 × tensor 2 within this share of data 2 × expert 2's; float32 losses within
#: this of expert 2 × tensor 1's
ETP_BF16_REL, ETP_F32_REL = 2e-3, 1e-6
#: the comm layer's collectives the wire meter times
WIRE_NAMES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce", "broadcast", "all_to_all_single")


class WireMeter:
    """The host seconds inside the comm layer's collectives, each fenced by
    CUDA synchronizes before and after (gloo copies CUDA tensors through
    host memory, so a collective waits for the work before it anyway)."""

    def __init__(self):
        from deepspeed_tpu_torch.comm import comm
        self.comm, self.seconds, self._saved = comm, 0.0, {}

    def _timed(self, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        return run

    def __enter__(self):
        for name in WIRE_NAMES:
            self._saved[name] = getattr(self.comm, name)
            setattr(self.comm, name, self._timed(self._saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.comm, name, fn)
        return False


def zero_reckoning(n: int, world: int, stage: int) -> dict:
    """The state bytes one rank holds of Llama-125M's ``n`` parameters (every
    tensor has a dim that 3 and 4 divide): bf16 parameters, a float32 master
    and two float32 moments, the master and moments a 1/world slice from
    stage 1, the parameters too at stage 3."""
    state = n // world if stage >= 1 else n
    return {"params": 2 * (n // world if stage >= 3 else n), "master": 4 * state, "moments": 8 * state}


HASH_CHUNK = 1 << 24


def device_hash(t: torch.Tensor) -> int:
    """A hash of ``t``'s bits computed on the card: its 16- or 32-bit words
    times (i + 1)·0x1E3779B97F4A7C15, summed with int64 wraparound (an
    integer sum: the same whatever the order).  A word that differs
    changes the sum by d·w, which is not 0 mod 2^64 for |d| < 2^32 and
    i < 2^31."""
    words = t.detach().contiguous().view(-1)
    words = words.view(torch.int16 if words.element_size() == 2 else torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=words.device)
    for start in range(0, words.numel(), HASH_CHUNK):   # chunks: a bank's int64 words would take GBs
        chunk = words[start:start + HASH_CHUNK].to(torch.int64)
        weights = torch.arange(start + 1, start + chunk.numel() + 1, device=words.device,
                               dtype=torch.int64) * 0x1E3779B97F4A7C15
        total += (chunk * weights).sum()   # int64 wraparound: the same sum in any chunking
    return int(total)


def zero_digest(engine) -> tuple:
    """The hash of each whole parameter (a collective at stage 3) and whole master tensor."""
    tensors = list(engine.module_state_dict().values()) + list((engine.full_master() or {}).values())
    return tuple(device_hash(t) for t in tensors)


def zero_stage_run(stage: int, cfg: LlamaConfig, dtype: torch.dtype, steps: int, meter: WireMeter,
                   timed_from=None, keep_params: bool = False, tp: int = 1, rows: int = BENCH_B) -> dict:
    """One engine at ``stage`` on this rank, ``steps`` train_batch calls on
    the repeated global batch (its first ``rows`` rows; the steps from
    ``timed_from`` on timed as one window ended by a fetch of the loss),
    over ``tp`` tensor-parallel ranks; its figures, and with ``keep_params``
    its whole parameters."""
    from deepspeed_tpu_torch.comm import comm
    t_start = time.perf_counter()
    acc = get_accelerator()
    gc.collect()
    torch.cuda.empty_cache()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    ds = {**BENCH_DS_CONFIG, "zero_optimization": {"stage": stage}, "train_batch_size": rows}
    if tp > 1:
        ds["tensor_parallel"] = {"autotp_size": tp}
    if dtype == torch.float32:
        ds = {k: v for k, v in ds.items() if k != "bf16"}
    engine = build_trainer(cfg, ds)
    batch = {k: v[:rows] for k, v in dp_batch().items()}
    reset_launch_counts()
    calls, wire, losses = comm.call_counts.copy(), meter.seconds, []
    for i in range(steps):
        if i == timed_from:
            float(losses[-1])
            calls, wire, t0 = comm.call_counts.copy(), meter.seconds, time.perf_counter()
        losses.append(engine.train_batch(batch=batch))
    float(losses[-1])                    # the value fetch ends the window
    timed = steps - (timed_from or 0)
    res = {"losses": [float(l) for l in losses], "partitioned": engine.zero is not None,
           "launches": {f.__name__: f.launches for f in FLASH_COUNTERS},
           "collectives_per_step": {k: v / timed for k, v in (comm.call_counts - calls).items()},
           "wire_ms_per_step": 1e3 * (meter.seconds - wire) / timed, "state_bytes": engine.state_bytes(),
           "peak_mem_gb": acc.max_memory_allocated() / 1e9}
    if timed_from is not None:
        res["step_ms"] = 1e3 * (time.perf_counter() - t0) / timed
    res["digest"] = zero_digest(engine)
    if tp > 1:   # phase 27: the rank's slices, its heads and its replicated tensors (whole over its data group)
        res["local_params"] = sum(math.prod(p.shape) for p in engine.zero.param_parts)
        attn = engine.module.layers[0].self_attn
        res["heads"] = (attn.n_heads, attn.n_kv)
        idx = [i for i, n in enumerate(engine.param_names) if n not in engine._tp_cut]
        res["replicated_digest"] = tuple(device_hash(t) for t in engine.zero.full_params(idx))
    whole = engine.module_state_dict()
    res["n_params"] = sum(v.numel() for v in whole.values())
    # numpy, not tensors: a queue would share a tensor's storage with the parent through a handle
    res["params"] = {k: v.detach().float().cpu().numpy() for k, v in whole.items()} if keep_params else None
    res["seconds"] = time.perf_counter() - t_start
    del engine
    return res


def reduce_scatter_routes(n: int, world: int) -> dict:
    """ms of one ``comm.reduce_scatter_tensor`` of ``n`` float32 elements on
    the card by each route of gloo (its own collective, ``native``; one
    all-to-all and a sum in rank order, ``all_to_all``, the engine's), in
    ``ZERO_RS_ORDER[world]``, each fenced by a barrier and synchronizes; and
    whether the two agree."""
    from deepspeed_tpu_torch.comm import comm
    x = torch.randn(n, device="cuda", generator=torch.Generator("cuda").manual_seed(comm.get_rank()))
    key, saved, ms, got = ("gloo", "cuda"), comm.REDUCE_SCATTER_ROUTES[("gloo", "cuda")], {}, {}
    try:
        for route in ZERO_RS_ORDER[world]:
            comm.REDUCE_SCATTER_ROUTES[key] = route
            out = torch.empty(n // world, device="cuda")
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comm.reduce_scatter_tensor(out, x)
            torch.cuda.synchronize()
            ms[route], got[route] = 1e3 * (time.perf_counter() - t0), out
    finally:
        comm.REDUCE_SCATTER_ROUTES[key] = saved
    return {"ms": ms, "agree": bool(torch.allclose(got["native"], got["all_to_all"], rtol=1e-5, atol=1e-5))}


def ep_reckoning(cfg: MixtralConfig, local_params: int, world: int, ep: int) -> dict:
    """The state bytes one rank holds at ZeRO-2 in bf16 of a Mixtral of
    which it holds ``local_params`` parameters (the dense ones and E/ep
    experts of each bank): its bf16 parameters, and a float32 master and two
    float32 moments of 1/world of the dense tensors (each has a dim 4
    divides) and of the banks (their expert dim over (expert, data): 2
    whole experts of 8 a rank)."""
    banks = 3 * cfg.num_local_experts * cfg.hidden_size * cfg.intermediate_size * cfg.num_hidden_layers
    state = (local_params - banks // ep) // world + banks // world
    return {"params": 2 * local_params, "master": 4 * state, "moments": 8 * state}


def ep_run(cfg: MixtralConfig, steps: int, meter: WireMeter, ep: int, seq: int, seed: int,
           timed_from=None, tp: int = 1, gas: int = 1) -> dict:
    """A Mixtral of ``cfg`` (its dtype: bf16 or float32 training) built with
    this rank's experts (``expert_parallel_size=ep``) and tensor slices
    (``tensor_parallel=tp``), seeded, through ``initialize`` at ZeRO-2 over
    the ranks; ``steps`` train_batch calls on one repeated global batch of
    as many rows of ``seq`` as ranks, split over the data-parallel ranks
    and ``gas`` micro-batches, those from ``timed_from`` on timed as one
    window; its figures, with the first step's ``exp_counts`` summed over
    its MoE forwards."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.utils import groups
    world = comm.get_world_size()
    t_start = time.perf_counter()
    acc = get_accelerator()
    gc.collect()
    torch.cuda.empty_cache()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    model = MixtralForCausalLM(cfg, device="cuda", expert_parallel_size=ep, tensor_parallel=tp)
    init_weights_(model, torch.Generator(device="cuda").manual_seed(seed))
    ds = {"train_batch_size": world, "gradient_accumulation_steps": gas,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
          "zero_optimization": {"stage": 2}, "moe": {"enabled": True, "expert_parallel_size": ep},
          "steps_per_print": 0}
    if tp > 1:
        ds["tensor_parallel"] = {"autotp_size": tp}
    if cfg.dtype == torch.bfloat16:
        ds["bf16"] = {"enabled": True}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=ds, device="cuda",
                                                loss_fn=make_mixtral_loss_fn(cfg))
    build_s = time.perf_counter() - t_start
    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (world, seq),
                                                                dtype=np.int32)).cuda()
    batch = {"input_ids": ids, "labels": ids}
    reset_launch_counts()
    comm.all_to_all_kinds.clear()
    comm.tensor_parallel_kinds.clear()
    calls, wire, losses = comm.call_counts.copy(), meter.seconds, []
    records, hooks = record_moe_layers(engine.module)
    for i in range(steps):
        if i == timed_from:
            float(losses[-1])
            calls, wire, t0 = comm.call_counts.copy(), meter.seconds, time.perf_counter()
        losses.append(engine.train_batch(batch=batch))
        if i == 0:   # the first step's forwards (and their recomputes under remat)
            counts = torch.stack([c for _, c, _ in records]).sum(0).cpu().numpy()
            for h in hooks:
                h.remove()
    float(losses[-1])
    timed = steps - (timed_from or 0)
    peak = acc.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    banks = {n for n in engine.param_names if ".experts." in n}
    named = list(zip(engine.param_names, engine.params))
    res = {"losses": [float(l) for l in losses], "launches": {f.__name__: f.launches for f in FLASH_COUNTERS},
           "all_to_alls": {f"{kind}_{way}": n for (kind, way), n in comm.all_to_all_kinds.items()},
           "collectives_per_step": {k: v / timed for k, v in (comm.call_counts - calls).items()},
           "wire_ms_per_step": 1e3 * (meter.seconds - wire) / timed, "state_bytes": engine.state_bytes(),
           "peak_mem_gb": peak, "local_params": sum(p.numel() for p in engine.params),
           "dense_digest": tuple(device_hash(p) for n, p in named if n not in banks),
           "bank_digest": tuple(device_hash(p) for n, p in named if n in banks),
           "replicated_digest": tuple(device_hash(p) for n, p in named if n not in banks and n not in engine._tp_cut),
           "expert_coord": groups.get_expert_parallel_rank(), "tensor_coord": groups.get_tensor_model_parallel_rank(),
           "exp_counts": counts, "tp_collectives": {f"{k}_{d}": n for (k, d), n in comm.tensor_parallel_kinds.items()},
           "heads": (engine.module.layers[0].self_attn.n_heads, engine.module.layers[0].self_attn.n_kv),
           "build_s": build_s}
    if timed_from is not None:
        res["step_ms"] = 1e3 * (time.perf_counter() - t0) / timed
    res["seconds"] = time.perf_counter() - t_start
    del engine, model
    return res


def expert_parallel_rank(meter: WireMeter) -> dict:
    """Phase 25's expert-parallel run on one of the W = 4 ranks: Mixtral-
    8x7B's widths at ``EP_LAYERS`` layer over data 2 × expert 2, then the
    float32 parity losses of expert 2 and expert 1 at ``EP_PARITY``."""
    cfg = dataclasses.replace(MIXTRAL_PRESETS["mixtral-8x7b"], num_hidden_layers=EP_LAYERS,
                              max_position_embeddings=EP_S, remat=True, remat_policy="flash_saveable",
                              attention_impl="flash")
    out = {"bf16": ep_run(cfg, EP_STEPS, meter, EP_SIZE, EP_S, seed=25, timed_from=EP_TIMED_FROM)}
    out["f32"] = {ep: ep_run(EP_PARITY, EP_PARITY_STEPS, meter, ep, EP_PARITY_S, seed=26) for ep in (1, EP_SIZE)}
    # expert 2 × tensor 2 on the same rows, and in float32 against expert 2 × tensor 1 (the same gating groups)
    out["etp"] = {"bf16": ep_run(cfg, EP_STEPS, meter, EP_SIZE, EP_S, seed=25, timed_from=EP_TIMED_FROM, tp=ETP_TP),
                  "f32": ep_run(EP_PARITY, EP_PARITY_STEPS, meter, EP_SIZE, EP_PARITY_S, seed=26, tp=ETP_TP,
                                gas=ETP_GAS)}
    return out


def tensor_parallel_rank(meter: WireMeter) -> dict:
    """Phase 27(b) on one of phase 25's W = 4 ranks, data 2 x tensor 2:
    Llama-125M as phase 6 on the first ``TP_TRAIN_ROWS`` rows (one warm-up
    and one timed step), then float32 at 2 layers, stages 0 and 3, on phase
    25's float32 batch."""
    out = {"bf16": zero_stage_run(2, llama_125m(), torch.bfloat16, ZERO_STEPS, meter, timed_from=ZERO_TIMED_FROM,
                                  tp=TP_SIZE, rows=TP_TRAIN_ROWS)}
    parity = llama_125m(num_hidden_layers=ZERO_PARITY_LAYERS, dtype=torch.float32)
    out["f32"] = {stage: zero_stage_run(stage, parity, torch.float32, ZERO_PARITY_STEPS, meter, tp=TP_SIZE)
                  for stage in TP_PARITY_STAGES}
    return out


def zero_rank(rank: int, world: int) -> dict:
    """Phase 25 on one rank: the bf16 stages of ``ZERO_RUNS[world]`` at full
    depth, the float32 parity runs of ``ZERO_PARITY_RUNS[world]`` at 2 layers
    (rank 0 returns their whole parameters), then at W = 4 phase 27's
    tensor-parallel runs and the expert-parallel Mixtral run."""
    out = {"bf16": {}, "f32": {}}
    with WireMeter() as meter:
        for stage in ZERO_RUNS[world]:
            out["bf16"][stage] = zero_stage_run(stage, llama_125m(), torch.bfloat16, ZERO_STEPS, meter,
                                                timed_from=ZERO_TIMED_FROM)
        # the stage-2 gradient buffer: every parameter in float32
        out["rs_routes"] = reduce_scatter_routes(out["bf16"][ZERO_RUNS[world][0]]["n_params"], world)
        parity = llama_125m(num_hidden_layers=ZERO_PARITY_LAYERS, dtype=torch.float32)
        for stage in ZERO_PARITY_RUNS[world]:
            out["f32"][stage] = zero_stage_run(stage, parity, torch.float32, ZERO_PARITY_STEPS, meter,
                                               keep_params=rank == 0)
        if world == 2 * TP_SIZE:
            out["tp"] = tensor_parallel_rank(meter)
            out["zoo_tp"] = zoo_tensor_parallel_rank(meter)
        if world == 2 * EP_SIZE:
            out["ep"] = expert_parallel_rank(meter)
    return out


def zero_rank_main(rank: int, init_methods, queue) -> None:
    """A spawned rank of phase 25 (the ranks share the one card, cuda:0,
    over gloo): each world of ``ZERO_RUNS`` in turn, largest first, over a
    process group of its own (``init_methods[world]``); the ranks beyond a
    world's size stop before it (a rank that waited for a later world's
    rendezvous instead backed off for ~50 s).  Puts ``{world: zero_rank(...)}``."""
    from deepspeed_tpu_torch.comm import comm
    try:
        torch.cuda.set_device(0)
        out = {}
        for world in sorted(ZERO_RUNS, reverse=True):
            if rank >= world:
                break
            comm.init_distributed(dist_backend="gloo", init_method=init_methods[world], rank=rank, world_size=world,
                                  timeout=ZERO_TIMEOUT_S, verbose=False)
            out[world] = zero_rank(rank, world)
            torch.distributed.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if comm.is_initialized():
            torch.distributed.destroy_process_group()


def spawn_ranks(target, n: int, timeout: float, groups=(None, ), extra=()) -> list:
    """``target(rank, init_methods, queue, *extra)`` on ``n`` spawned processes,
    ``init_methods`` a free localhost TCP address for each key of
    ``groups``; their results in rank order, or raises with a failed
    rank's traceback.  Every process is joined (or terminated) before it
    returns."""
    import multiprocessing
    import socket
    gc.collect()
    torch.cuda.empty_cache()
    init_methods = {}
    for key in groups:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            init_methods[key] = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, init_methods, queue) + tuple(extra)) for r in range(n)]
    for p in procs:
        p.start()
    ranks = {}
    try:
        for _ in range(n):
            rank, res, err = queue.get(timeout=timeout)
            if err is not None:
                raise AssertionError(f"rank {rank} of {n} failed:\n{err}")
            ranks[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks exited with {[p.exitcode for p in procs]}")
    return [ranks[r] for r in range(n)]


def share_beyond(got: dict, want: dict, tight: float) -> tuple:
    """The share of all entries of ``got`` further than ``tight`` from
    ``want``, and the largest distance."""
    diff = np.concatenate([np.abs(got[k] - want[k]).reshape(-1) for k in want])
    return float((diff > tight).mean()), float(diff.max())


def phase_expert_parallel(spawned: list, mixtral_params: int) -> tuple:
    """Phase 25's expert-parallel figures and checks from the W = 4 ranks,
    and their K1/K2a/K2b launches."""
    runs = [r[2 * EP_SIZE]["ep"]["bf16"] for r in spawned]
    f32 = {ep: run["losses"] for ep, run in spawned[0][2 * EP_SIZE]["ep"]["f32"].items()}
    cfg = MIXTRAL_PRESETS["mixtral-8x7b"]
    banks = 3 * cfg.num_local_experts * cfg.hidden_size * cfg.intermediate_size * EP_LAYERS
    local = mixtral_params - banks + banks // EP_SIZE
    want = ep_reckoning(dataclasses.replace(cfg, num_hidden_layers=EP_LAYERS), local, len(runs), EP_SIZE)
    a2a = {"dispatch_forward": 2 * EP_LAYERS * EP_STEPS, "combine_forward": 2 * EP_LAYERS * EP_STEPS,
           "dispatch_backward": EP_LAYERS * EP_STEPS, "combine_backward": EP_LAYERS * EP_STEPS}
    losses = runs[0]["losses"]
    rel = float(np.max(np.abs(np.array(f32[EP_SIZE]) - f32[1]) / np.abs(f32[1])))
    by_coord = {}
    for r in runs:
        by_coord.setdefault(r["expert_coord"], set()).add(r["bank_digest"])
    checks = {
        "ep_losses_finite": bool(np.all(np.isfinite(losses))),
        "ep_second_loss_below_first": losses[1] < losses[0],
        "ep_losses_equal_on_ranks": all(r["losses"] == losses for r in runs),
        "ep_dense_bit_identical_on_ranks": len({r["dense_digest"] for r in runs}) == 1,
        "ep_banks_bit_identical_in_expert_data_groups": all(len(d) == 1 for d in by_coord.values())
        and len({next(iter(d)) for d in by_coord.values()}) == EP_SIZE,
        "ep_local_params": all(r["local_params"] == local for r in runs),
        "ep_state_bytes_reckoned": all(r["state_bytes"] == want for r in runs),
        "ep_all_to_alls_by_kind": all(r["all_to_alls"] == a2a for r in runs),
        "ep_k1_k2_per_layer_step": all(n == EP_LAYERS * EP_STEPS for r in runs for n in r["launches"].values()),
        "ep_f32_parity_rtol_1e-5": rel <= 1e-5,
    }
    res = {"config": f"Mixtral-8x7B widths, {EP_LAYERS} layer, data 2 x expert {EP_SIZE}, ZeRO-2, bf16, AdamW, "
                     f"B {len(runs)} of S {EP_S}", "losses": losses, "step_ms": [r["step_ms"] for r in runs],
           "wire_ms_per_step": [r["wire_ms_per_step"] for r in runs], "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
           "peak_mem_gb_sum": sum(r["peak_mem_gb"] for r in runs), "state_bytes": runs[0]["state_bytes"],
           "reckoned_bytes": want, "local_params": runs[0]["local_params"], "all_to_alls": runs[0]["all_to_alls"],
           "collectives_per_step": runs[0]["collectives_per_step"],
           "launches_per_step": {k: v / EP_STEPS for k, v in runs[0]["launches"].items()},
           "build_s": [r["build_s"] for r in runs], "run_s": [r["seconds"] for r in runs],
           "f32_parity": {"losses_ep1": f32[1], f"losses_ep{EP_SIZE}": f32[EP_SIZE], "loss_rel": rel},
           "tok_s_all_ranks": len(runs) * EP_S / (max(r["step_ms"] for r in runs) / 1e3)}
    launches = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    res["expert_x_tensor"], etp_checks, res["etp_launches"] = expert_tensor_figures(spawned, losses[0])
    checks.update(etp_checks)
    return res, checks, launches


def expert_tensor_figures(spawned: list, ep_first_loss: float) -> tuple:
    """Phase 25's expert 2 × tensor 2 run (Mixtral-8x7B's widths at one
    layer, ZeRO-2, bf16) and its float32 parity: figures, checks and K1/K2a/K2b
    launches.  The state a rank holds: its bf16 parameters; a float32
    master and two moments of its dense tensors' slices over the 2 ranks
    of its data-parallel group and of its banks' slices whole (the ranks
    that share its expert and tensor coordinates: itself)."""
    world = 2 * EP_SIZE
    runs = [r[world]["ep"]["etp"]["bf16"] for r in spawned]
    f32 = [r[world]["ep"]["etp"]["f32"] for r in spawned]
    ref = [r[world]["ep"]["f32"][EP_SIZE] for r in spawned]      # expert 2 x tensor 1, the same gating groups
    cfg = MIXTRAL_PRESETS["mixtral-8x7b"]
    bank_slice = 3 * (cfg.num_local_experts // EP_SIZE) * cfg.hidden_size * (cfg.intermediate_size // ETP_TP)
    state = (ETP_RANK_PARAMS - bank_slice) // (world // ETP_TP) + bank_slice
    want = {"params": 2 * ETP_RANK_PARAMS, "master": 4 * state, "moments": 8 * state}
    losses = runs[0]["losses"]
    f32_rel = float(np.max(np.abs(np.array(f32[0]["losses"]) - ref[0]["losses"]) / np.abs(ref[0]["losses"])))
    checks = {
        "etp_local_params": all(r["local_params"] == ETP_RANK_PARAMS for r in runs),
        "etp_state_bytes_reckoned": all(r["state_bytes"] == want for r in runs),
        "etp_heads_16_4": all(r["heads"] == (16, 4) for r in runs),
        "etp_k1_k2_once_a_step": all(n == EP_LAYERS * EP_STEPS for r in runs for n in r["launches"].values()),
        "etp_losses_equal_on_ranks": all(r["losses"] == losses for r in runs),
        "etp_losses_finite": bool(np.all(np.isfinite(losses))),
        "etp_first_loss_within_2e-3_of_ep2": abs(losses[0] - ep_first_loss) <= ETP_BF16_REL * abs(ep_first_loss),
        "etp_replicated_bit_identical": len({r["replicated_digest"] for r in runs}) == 1,
        # one MoE all-reduce a layer's forward (the remat recompute stops before it: nothing after it is saved
        # for the backward; it reruns the o_proj all-reduce, whose output the next norm saves)
        "etp_one_moe_reduce_a_layer_forward": all(
            r["tp_collectives"].get("moe_forward") == EP_LAYERS * EP_STEPS
            and r["tp_collectives"].get("o_proj_forward") == 2 * EP_LAYERS * EP_STEPS for r in runs),
        "etp_f32_losses_within_1e-6_of_tensor_1": f32_rel <= ETP_F32_REL,
        "etp_f32_replicated_bit_identical": len({r["replicated_digest"] for r in f32}) == 1,
        "etp_f32_exp_counts_equal_tensor_1": all(np.array_equal(r["exp_counts"], ref[0]["exp_counts"]) for r in f32),
    }
    res = {"config": f"Mixtral-8x7B widths, {EP_LAYERS} layer, expert {EP_SIZE} x tensor {ETP_TP}, ZeRO-2, bf16, "
                     f"AdamW, the same {world} rows of S {EP_S} as data 2 x expert 2 ({ETP_TP} a data rank)",
           "losses": losses, "ep2_first_loss": ep_first_loss, "local_params": runs[0]["local_params"],
           "whole_params": ETP_WHOLE_PARAMS, "state_bytes": runs[0]["state_bytes"], "reckoned_bytes": want,
           "step_ms": [r["step_ms"] for r in runs], "wire_ms_per_step": [r["wire_ms_per_step"] for r in runs],
           "collectives_per_step": runs[0]["collectives_per_step"], "tp_collectives": runs[0]["tp_collectives"],
           "all_to_alls": runs[0]["all_to_alls"], "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
           "launches_per_step": {k: v / EP_STEPS for k, v in runs[0]["launches"].items()},
           "build_s": [r["build_s"] for r in runs], "run_s": [r["seconds"] for r in runs],
           "f32_parity": {"losses_tensor_1": ref[0]["losses"], "losses_tensor_2": f32[0]["losses"],
                          "loss_rel": f32_rel, "exp_counts": f32[0]["exp_counts"].tolist(),
                          "run_s": [r["seconds"] for r in f32]}}
    launches = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    return res, checks, launches


def phase_tensor_parallel_training(spawned: list, first_rows_loss: float) -> tuple:
    """Phase 27(b)'s figures and checks from the W = 4 ranks (data 2 x
    tensor 2), and their K1/K2a/K2b launches."""
    world = 2 * TP_SIZE
    runs = [r[world]["tp"] for r in spawned[:world]]
    bf16 = [r["bf16"] for r in runs]
    layers = PRESETS["125m"].num_hidden_layers
    want = zero_reckoning(TP_RANK_PARAMS_125M, world // TP_SIZE, 2)
    losses = bf16[0]["losses"]
    f32_ref = spawned[0][world]["f32"][0]["losses"]     # phase 25's W = 4 tensor-1 float32 run, same batch
    checks = {
        "tp_train_local_params": all(r["local_params"] == TP_RANK_PARAMS_125M for r in bf16),
        "tp_train_whole_params": all(r["n_params"] == TP_WHOLE_PARAMS_125M for r in bf16),
        "tp_train_state_bytes_reckoned": all(r["state_bytes"] == want for r in bf16),
        "tp_train_heads_6_6": all(r["heads"] == (6, 6) for r in bf16),
        "tp_train_k1_k2_12_per_step": all(n == layers * ZERO_STEPS for r in bf16 for n in r["launches"].values()),
        "tp_train_losses_equal_on_ranks": all(r["losses"] == losses for r in bf16),
        "tp_train_losses_finite": bool(np.all(np.isfinite(losses))),
        "tp_train_first_loss_within_1e-2_of_one_rank": abs(losses[0] - first_rows_loss) <= 1e-2 * abs(first_rows_loss),
        "tp_train_ranks_bit_identical": len({r["digest"] for r in bf16}) == 1,
    }
    parity = {}
    for stage in TP_PARITY_STAGES:
        f32 = [r["f32"][stage] for r in runs]
        rel = float(np.max(np.abs(np.array(f32[0]["losses"]) - f32_ref) / np.abs(f32_ref)))
        parity[stage] = {"losses": f32[0]["losses"], "loss_rel": rel, "run_s": [r["seconds"] for r in f32]}
        checks[f"tp_train_f32_s{stage}_losses_rtol_1e-5"] = rel <= 1e-5
        checks[f"tp_train_f32_s{stage}_replicated_bit_identical"] = len({r["replicated_digest"] for r in f32}) == 1
        checks[f"tp_train_f32_s{stage}_losses_equal_on_ranks"] = all(r["losses"] == f32[0]["losses"] for r in f32)
    res = {"config": f"Llama-125M, data {world // TP_SIZE} x tensor {TP_SIZE}, ZeRO-2, bf16, AdamW, remat "
                     f"flash_saveable, B {TP_TRAIN_ROWS} of S {BENCH_S} ({TP_TRAIN_ROWS * TP_SIZE // world} rows a "
                     "data rank)", "losses": losses, "one_rank_first_loss": first_rows_loss,
           "local_params": bf16[0]["local_params"], "state_bytes": bf16[0]["state_bytes"], "reckoned_bytes": want,
           "step_ms": [r["step_ms"] for r in bf16], "wire_ms_per_step": [r["wire_ms_per_step"] for r in bf16],
           "collectives_per_step": bf16[0]["collectives_per_step"], "peak_mem_gb": [r["peak_mem_gb"] for r in bf16],
           "launches_per_step": {k: v / ZERO_STEPS for k, v in bf16[0]["launches"].items()},
           "run_s": [r["seconds"] for r in bf16], "f32_parity": {"reference_losses": f32_ref, **parity},
           "tok_s_all_ranks": TP_TRAIN_ROWS * BENCH_S / (max(r["step_ms"] for r in bf16) / 1e3)}
    launches = {k: sum(r["launches"][k] for r in bf16) for k in bf16[0]["launches"]}
    return res, checks, launches


def phase_zero(smi: str, mixtral_params: int, first_rows_loss: float) -> dict:
    layers = PRESETS["125m"].num_hidden_layers
    res, checks = {"card": smi}, {}
    launches = {f.__name__: 0 for f in FLASH_COUNTERS}
    t0 = time.perf_counter()
    spawned = spawn_ranks(zero_rank_main, max(ZERO_RUNS), ZERO_TIMEOUT_S * len(ZERO_RUNS), groups=tuple(ZERO_RUNS))
    res["spawn_s"] = time.perf_counter() - t0
    # W = 4 trains stage 3 only: its losses and peaks are held to W = 3's stage 0 on the same global batch
    base_ranks = [r[3]["bf16"][0] for r in spawned[:3]]
    for world, stages in ZERO_RUNS.items():
        ranks = [r[world] for r in spawned[:world]]
        base = base_ranks[0]
        n = base["n_params"]
        per_stage = {}
        for stage in stages:
            runs = [r["bf16"][stage] for r in ranks]
            want = zero_reckoning(n, world, stage)
            for r in runs:
                for k in launches:
                    launches[k] += r["launches"][k]
            tag = f"w{world}_s{stage}"
            checks[f"{tag}_partitioned"] = all(r["partitioned"] == (stage > 0) for r in runs)
            checks[f"{tag}_k1_k2_12_per_step"] = all(r["launches"][k] == layers * ZERO_STEPS for r in runs
                                                     for k in r["launches"])
            checks[f"{tag}_ranks_bit_identical"] = len({r["digest"] for r in runs}) == 1
            checks[f"{tag}_losses_equal_on_ranks"] = all(r["losses"] == runs[0]["losses"] for r in runs)
            checks[f"{tag}_losses_finite"] = bool(np.all(np.isfinite(runs[0]["losses"])))
            checks[f"{tag}_losses_within_bf16_of_stage0"] = bool(np.allclose(runs[0]["losses"], base["losses"],
                                                                             rtol=1e-2, atol=0))
            checks[f"{tag}_state_bytes_reckoned"] = all(r["state_bytes"] == want for r in runs)
            per_stage[stage] = {
                "losses": runs[0]["losses"], "step_ms": [r["step_ms"] for r in runs],
                "wire_ms_per_step": [r["wire_ms_per_step"] for r in runs],
                "collectives_per_step": runs[0]["collectives_per_step"], "state_bytes": runs[0]["state_bytes"],
                "state_gb": sum(runs[0]["state_bytes"].values()) / 1e9, "reckoned_bytes": want,
                "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
                "launches_per_step": {k: v / ZERO_STEPS for k, v in runs[0]["launches"].items()},
                "run_s": [r["seconds"] for r in runs],
                "tok_s_all_ranks": BENCH_B * BENCH_S / (max(r["step_ms"] for r in runs) / 1e3)}
        if 3 in stages:
            checks[f"w{world}_stage3_peak_below_w3_stage0"] = all(
                r["bf16"][3]["peak_mem_gb"] < min(b["peak_mem_gb"] for b in base_ranks) for r in ranks)
        parity = {}
        f32 = ranks[0]["f32"]
        for stage, run in f32.items():
            if stage == 0:
                continue
            share, worst = share_beyond(run["params"], f32[0]["params"], 1e-6)
            rel = float(np.max(np.abs(np.array(run["losses"]) - f32[0]["losses"]) / np.abs(f32[0]["losses"])))
            parity[stage] = {"losses": run["losses"], "loss_rel": rel, "share_beyond_1e-6": share, "max_abs": worst,
                             "run_s": run["seconds"]}
            checks[f"w{world}_s{stage}_f32_losses_rtol_1e-5"] = rel <= 1e-5
            checks[f"w{world}_s{stage}_f32_params_1e-6"] = share <= 1e-3 and worst <= 2 * 1e-4 * ZERO_PARITY_STEPS
            checks[f"w{world}_s{stage}_f32_ranks_bit_identical"] = len({r["f32"][stage]["digest"] for r in ranks}) == 1
        checks[f"w{world}_reduce_scatter_routes_agree"] = all(r["rs_routes"]["agree"] for r in ranks)
        res[f"w{world}"] = {"stages": per_stage, "f32_parity": parity, "f32_stage0_losses": f32[0]["losses"],
                            "rows_per_rank": BENCH_B // world,
                            "reduce_scatter_ms": {"order": ZERO_RS_ORDER[world],
                                                  **{route: [r["rs_routes"]["ms"][route] for r in ranks]
                                                     for route in ZERO_RS_ORDER[world]}}}
        log(f"  zero W = {world}: " + json.dumps(res[f"w{world}"]))
    res["expert_parallel"], ep_checks, res["ep_launches"] = phase_expert_parallel(spawned, mixtral_params)
    res["etp_launches"] = res["expert_parallel"].pop("etp_launches")
    checks.update(ep_checks)
    log("  expert parallel: " + json.dumps(res["expert_parallel"]))
    res["tensor_parallel"], tp_checks, res["tp_launches"] = phase_tensor_parallel_training(spawned, first_rows_loss)
    checks.update(tp_checks)
    res["zoo_tensor_parallel"], zoo_checks, res["zoo_tp_launches"] = phase_zoo_tensor_parallel_training(spawned)
    checks.update(zoo_checks)
    log("== phase 27(b): tensor-parallel training in phase 25's W = 4 spawn (data 2 x tensor 2)")
    log("  tensor parallel training: " + json.dumps(res["tensor_parallel"]))
    log("  tensor parallel training of the dense zoo: " + json.dumps(res["zoo_tensor_parallel"]))
    res["launches"] = launches
    res["checks"] = checks
    log(f"  zero: one spawn of {max(ZERO_RUNS)} ranks, {res['spawn_s']:.1f} s")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"ZeRO phase failed {bad}")
    return res


# ---------------------------------------------------------------- phase 25: the dense zoo at data 2 x tensor 2

#: Phi-2's widths cut to ZOO_LAYERS layers over data 2 x tensor 2 (ZeRO-2, bf16, one step on phase 27(b)'s
#: rows): a rank's parameters and the whole model's; of a rank's, those held whole over its data group: the
#: 1-D biases cut over ``tensor`` (fc1's 2 x 5120, the head's 25,600) leave no dim for ``data`` (JAX keeps them
#: whole and puts ``data`` on them); its first loss within TP_PHI2_TRAIN_REL of data 4's (``eval_batch`` of a
#: data-4 engine on the same rows: a step's loss comes before its update)
TP_PHI2_TRAIN_RANK_PARAMS, TP_PHI2_TRAIN_WHOLE_PARAMS, TP_PHI2_TRAIN_DATA_WHOLE = 209_784_320, 419_543_040, 35_840
TP_PHI2_TRAIN_REL = 2e-3
#: float32 at 2 narrow layers (hidden 512, 8 heads of 64, vocab 4096), ZeRO-0, TP_ZOO_F32_STEPS AdamW steps on
#: TP_ZOO_F32_ROWS rows of TP_ZOO_F32_S tokens: tensor 2's losses within TP_ZOO_F32_REL of tensor 1's (data 4)
TP_ZOO_F32_ROWS, TP_ZOO_F32_S, TP_ZOO_F32_STEPS, TP_ZOO_F32_REL = 8, 256, 2, 1e-6
#: one Phi-2 block (its widths, float32) under ``checkpointing.checkpoint`` at tensor 2: B 1 of this S
TP_PARTITION_S = 1024


def tp_zoo_f32_configs() -> dict:
    """The narrow float32 families of phase 25's tensor-2 parity: Falcon-RW
    (alibi: the plain attention, as JAX) and Falcon's new architecture
    (the parallel block, 8:4 heads), OPT and Phi (16 heads' partial rotary)."""
    narrow = dict(vocab_size=4096, hidden_size=512, num_hidden_layers=2, num_attention_heads=8,
                  max_position_embeddings=TP_ZOO_F32_S, dtype=torch.float32, remat=True,
                  remat_policy="flash_saveable")
    return {"falcon-rw": FalconConfig(**narrow, num_kv_heads=8, alibi=True, parallel_attn=False, bias=True,
                                      attention_impl="reference"),
            "falcon-new": FalconConfig(**narrow, num_kv_heads=4, new_decoder_architecture=True,
                                       tie_word_embeddings=False, attention_impl="flash"),
            "opt": OPTConfig(**narrow, ffn_dim=2048, attention_impl="flash"),
            "phi": PhiConfig(**narrow, intermediate_size=2048, num_key_value_heads=8, partial_rotary_factor=0.5,
                             attention_impl="flash")}


def zoo_tp_train_run(cfg, rows: torch.Tensor, steps: int, meter: WireMeter, tp: int = 1, stage: int = 0,
                     evaluate: bool = False) -> dict:
    """One engine of ``cfg``'s family on this rank (seeded whole, cut by the
    engine over ``tp`` tensor-parallel ranks), ``steps`` train_batch calls
    on ``rows`` (or with ``evaluate`` one ``eval_batch``); its figures."""
    from deepspeed_tpu_torch.comm import comm
    t_start = time.perf_counter()
    acc = get_accelerator()
    gc.collect()
    torch.cuda.empty_cache()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    ds = {"train_batch_size": rows.shape[0], "steps_per_print": 0, "gradient_clipping": 1.0,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
          "zero_optimization": {"stage": stage}}
    if cfg.dtype == torch.bfloat16:
        ds["bf16"] = {"enabled": True}
    if tp > 1:
        ds["tensor_parallel"] = {"autotp_size": tp}
    model = init_weights_(training_model(cfg), torch.Generator(device="cuda").manual_seed(25))
    engine = deepspeed_tpu_torch.initialize(model=model, config=ds, device="cuda")[0]
    del model
    batch = {"input_ids": rows, "labels": rows}
    reset_launch_counts()
    calls, wire, t0 = comm.call_counts.copy(), meter.seconds, time.perf_counter()
    if evaluate:
        losses = [float(engine.eval_batch(batch=batch))]
    else:
        losses = [float(engine.train_batch(batch=batch)) for _ in range(steps)]
    window_s = time.perf_counter() - t0
    attn = first_attention(engine.module)
    res = {"losses": losses, "launches": {f.__name__: f.launches for f in FLASH_COUNTERS},
           "state_bytes": engine.state_bytes(), "heads": (attn.n_heads, attn.n_kv),
           "local_params": sum(p.numel() for p in engine.module.parameters()),
           "collectives": dict(comm.call_counts - calls), "step_ms": 1e3 * window_s / len(losses),
           "wire_ms": 1e3 * (meter.seconds - wire) / len(losses), "peak_mem_gb": acc.max_memory_allocated() / 1e9}
    if tp > 1:   # the replicated tensors (whole over the data group), hashed on the card; the whole model's size
        idx = [i for i, n in enumerate(engine.param_names) if n not in engine._tp_cut]
        res["replicated_digest"] = tuple(device_hash(t) for t in engine.zero.full_params(idx))
        res["n_params"] = sum(v.numel() for v in engine.module_state_dict().values())
    res["seconds"] = time.perf_counter() - t_start
    del engine
    return res


def partition_activations_check() -> dict:
    """One Phi-2 block (float32) at tensor 2 on the global mesh (data 2 x
    tensor 2), its input x [1, TP_PARTITION_S, 2560] and positions through
    ``checkpointing.checkpoint`` with ``partition_activations``, against the
    reentrant ``torch.utils.checkpoint`` (which saves its inputs whole): the
    output, x's gradient and the block's gradients, the floating bytes
    autograd saved (``saved_tensors_hooks``), and the gathers counted in
    the recompute."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models.phi import PhiBlock
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel, set_tensor_parallel_
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
    from deepspeed_tpu_torch.utils import groups
    cfg = dataclasses.replace(policy_for("phi").build_config(ZOO["phi-2"][0]), dtype=torch.float32,
                              param_dtype=torch.float32, attention_impl="flash")
    tp = TensorParallel(TP_SIZE, groups.get_tensor_model_parallel_rank(), groups.get_tensor_model_parallel_group())
    block = set_tensor_parallel_(PhiBlock(cfg, device="cuda", tp_size=TP_SIZE), tp)
    init_weights_(block, torch.Generator(device="cuda").manual_seed(28))
    x = torch.randn((1, TP_PARTITION_S, cfg.hidden_size), generator=torch.Generator(device="cuda").manual_seed(29),
                    device="cuda")
    positions = torch.arange(TP_PARTITION_S, device="cuda")[None]

    def run(fn):
        xi = x.clone().requires_grad_()
        saved = []

        def pack(t):
            if t.is_floating_point():
                saved.append(t.numel() * t.element_size())
            return t

        block.zero_grad(set_to_none=True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn(xi, positions)
        out.square().sum().backward()
        return out.detach(), [xi.grad] + [p.grad for p in block.parameters()], sum(saved)

    torch.backends.cuda.matmul.allow_tf32 = False
    checkpointing.configure(partition_activations=True)
    comm.tensor_parallel_kinds.clear()
    try:
        out, grads, saved = run(lambda *a: checkpointing.checkpoint(block, *a))
        kinds = {f"{k}_{d}": n for (k, d), n in comm.tensor_parallel_kinds.items()}
    finally:
        checkpointing.reset()
    want, want_grads, want_saved = run(lambda *a: torch.utils.checkpoint.checkpoint(block, *a, use_reentrant=True))
    diff = max(float((a - b).abs().max()) for a, b in zip([out] + grads, [want] + want_grads))
    return {"values_equal": bool(torch.equal(out, want)), "grads_equal": all(torch.equal(a, b)
                                                                             for a, b in zip(grads, want_grads)),
            "max_abs_diff": diff, "saved_bytes": saved, "whole_saved_bytes": want_saved,
            "gathers": kinds.get("partition_activations_backward", 0), "kinds": kinds}


def zoo_tensor_parallel_rank(meter: WireMeter) -> dict:
    """Slice 25's runs on one of phase 25's W = 4 ranks: Phi-2's widths at
    ZOO_LAYERS layers (bf16, ZeRO-2) evaluated at data 4 and trained one step
    at data 2 x tensor 2 on phase 27(b)'s rows, ``partition_activations``
    at tensor 2, then each narrow float32 family at tensor 1 and 2."""
    cfg = dataclasses.replace(policy_for("phi").build_config(cut_layers(ZOO["phi-2"][0], ["num_hidden_layers"],
                                                                        ZOO_LAYERS)),
                              remat=True, remat_policy="flash_saveable", attention_impl="flash")
    rows = dp_batch()["input_ids"][:TP_TRAIN_ROWS]
    out = {"phi2_data4": zoo_tp_train_run(cfg, rows, 1, meter, stage=2, evaluate=True),
           "phi2": zoo_tp_train_run(cfg, rows, 1, meter, tp=TP_SIZE, stage=2)}
    out["partition"] = partition_activations_check()
    gen = np.random.default_rng(25)
    f32_rows = torch.from_numpy(gen.integers(0, 4096, (TP_ZOO_F32_ROWS, TP_ZOO_F32_S), dtype=np.int64)).cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    out["f32"] = {name: {tp: zoo_tp_train_run(c, f32_rows, TP_ZOO_F32_STEPS, meter, tp=tp) for tp in (1, TP_SIZE)}
                  for name, c in tp_zoo_f32_configs().items()}
    return out


def zoo_tp_training_main(rank: int, init_methods, queue) -> None:
    """A spawned rank of ``phase_zoo_tensor_parallel_training_alone``:
    ``zoo_tensor_parallel_rank`` on four gloo ranks sharing the card."""
    from deepspeed_tpu_torch.comm import comm
    try:
        torch.cuda.set_device(0)
        world = 2 * TP_SIZE
        comm.init_distributed(dist_backend="gloo", init_method=init_methods[None], rank=rank, world_size=world,
                              timeout=ZERO_TIMEOUT_S, verbose=False)
        with WireMeter() as meter:
            queue.put((rank, {world: {"zoo_tp": zoo_tensor_parallel_rank(meter)}}, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if comm.is_initialized():
            torch.distributed.destroy_process_group()


def phase_zoo_tensor_parallel_training_alone(smi: str) -> dict:
    """Phase 25's Phi-2 and dense-zoo runs at data 2 x tensor 2 without the
    rest of phase 25: four ranks of their own.  Raises if a check fails."""
    build_kernel("flash_attention")     # once here: the ranks would race to build it
    res, checks, _ = phase_zoo_tensor_parallel_training(spawn_ranks(zoo_tp_training_main, 2 * TP_SIZE,
                                                                    ZERO_TIMEOUT_S))
    res["card"] = smi
    log("  tensor parallel training of the dense zoo: " + json.dumps(res))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"tensor-parallel zoo training failed {bad}")
    return res


def phase_zoo_tensor_parallel_training(spawned: list) -> tuple:
    """Slice 25's figures and checks from phase 25's W = 4 ranks, and their
    K1/K2a/K2b launches."""
    world = 2 * TP_SIZE
    runs = [r[world]["zoo_tp"] for r in spawned[:world]]
    phi = [r["phi2"] for r in runs]
    ref = runs[0]["phi2_data4"]["losses"][0]
    dp, whole = world // TP_SIZE, TP_PHI2_TRAIN_DATA_WHOLE
    state = (TP_PHI2_TRAIN_RANK_PARAMS - whole) // dp + whole
    want = {"params": 2 * TP_PHI2_TRAIN_RANK_PARAMS, "master": 4 * state, "moments": 8 * state}
    loss = phi[0]["losses"][0]
    checks = {
        "zoo_tp_phi2_local_params": all(r["local_params"] == TP_PHI2_TRAIN_RANK_PARAMS for r in phi),
        "zoo_tp_phi2_whole_params": all(r["n_params"] == TP_PHI2_TRAIN_WHOLE_PARAMS for r in phi),
        "zoo_tp_phi2_state_bytes_reckoned": all(r["state_bytes"] == want for r in phi),
        "zoo_tp_phi2_heads_16_16": all(r["heads"] == (16, 16) for r in phi),
        "zoo_tp_phi2_k1_k2_once_per_layer": all(n == ZOO_LAYERS for r in phi for n in r["launches"].values()),
        "zoo_tp_phi2_losses_equal_on_ranks": all(r["losses"] == phi[0]["losses"] for r in phi),
        "zoo_tp_phi2_first_loss_within_2e-3_of_data_4": abs(loss - ref) <= TP_PHI2_TRAIN_REL * abs(ref),
        "zoo_tp_phi2_replicated_bit_identical": len({r["replicated_digest"] for r in phi}) == 1}
    part = [r["partition"] for r in runs]
    checks.update({
        "partition_values_equal": all(p["values_equal"] for p in part),
        "partition_grads_equal": all(p["grads_equal"] for p in part),
        "partition_saved_bytes_halved": all(2 * p["saved_bytes"] == p["whole_saved_bytes"] > 0 for p in part),
        "partition_one_gather_in_the_recompute": all(p["gathers"] == 1 for p in part)})
    f32 = {}
    for name in tp_zoo_f32_configs():
        one, two = runs[0]["f32"][name][1], [r["f32"][name][TP_SIZE] for r in runs]
        rel = float(np.max(np.abs(np.array(two[0]["losses"]) - one["losses"]) / np.abs(one["losses"])))
        f32[name] = {"losses_tensor_1": one["losses"], "losses_tensor_2": two[0]["losses"], "loss_rel": rel,
                     "heads": two[0]["heads"], "run_s": [r["seconds"] for r in two]}
        checks[f"zoo_tp_f32_{name}_losses_within_1e-6_of_tensor_1"] = rel <= TP_ZOO_F32_REL
        checks[f"zoo_tp_f32_{name}_losses_equal_on_ranks"] = all(r["losses"] == two[0]["losses"] for r in two)
        checks[f"zoo_tp_f32_{name}_replicated_bit_identical"] = len({r["replicated_digest"] for r in two}) == 1
    res = {"config": f"Phi-2's widths at {ZOO_LAYERS} layers, data {world // TP_SIZE} x tensor {TP_SIZE}, ZeRO-2, "
                     f"bf16, AdamW, remat flash_saveable, B {TP_TRAIN_ROWS} of S {BENCH_S}", "losses": phi[0]["losses"],
           "data_4_first_loss": ref, "loss_rel": abs(loss - ref) / abs(ref), "local_params": phi[0]["local_params"],
           "state_bytes": phi[0]["state_bytes"], "reckoned_bytes": want, "step_ms": [r["step_ms"] for r in phi],
           "wire_ms": [r["wire_ms"] for r in phi], "collectives": phi[0]["collectives"],
           "peak_mem_gb": [r["peak_mem_gb"] for r in phi], "launches": phi[0]["launches"],
           "run_s": [r["seconds"] for r in phi], "data_4_run_s": [r["phi2_data4"]["seconds"] for r in runs],
           "partition_activations": part[0], "f32_parity": f32}
    every = [r[k] for r in runs for k in ("phi2_data4", "phi2")] + [r["f32"][n][t] for r in runs for n in f32
                                                                     for t in (1, TP_SIZE)]
    launches = {k: sum(r["launches"][k] for r in every) for k in phi[0]["launches"]}
    return res, checks, launches


# ---------------------------------------------------------------- phase 27

TP_SIZE = 2
#: 4 of phase 3's requests (prompts of 64, 300, 128 and 512 tokens), 16 new tokens each
TP_REQUESTS, TP_NEW = (0, 2, 4, 5), 16
#: the tensor-parallel engine's batch (its max_seqs and bucket): the 4 requests
TP_BATCH = 4
#: a rank's parameters over tensor 2 and the whole model's: Llama-3-8B (the 266,240 norm weights whole
#: on every rank, the rest halved) and Llama-125M (19,200 norm weights)
TP_RANK_PARAMS_8B, TP_WHOLE_PARAMS_8B = 4_015_263_744, 8_030_261_248
TP_RANK_PARAMS_125M, TP_WHOLE_PARAMS_125M = 67_062_528, 134_105_856
#: phase 27(b): the global batch's rows (4 a data rank at data 2) and the float32 stages
TP_TRAIN_ROWS, TP_PARITY_STAGES = 8, (0, 3)
#: float32 first-step logits of tensor 2 against one card: max |diff| within this share of the largest
TP_F32_LOGITS_TOL = 1e-4
#: K3's decode split at a rank's 16:4 heads and phase 27's batch of 4 (``choose_n_split``)
TP_K3_SPLIT = 8
#: phase 27's prompts are their first TP_PROMPT_CAP tokens: the prefill over gloo took most of the phase
TP_PROMPT_CAP = 128
#: phase 27(a)'s Qwen1.5-MoE-A2.7B over tensor 2: a rank's parameters (the norms, routers and shared-expert
#: gates whole, the rest halved) and the whole model's; its float32 check at TP_QWEN_F32_LAYERS layers
TP_QWEN_RANK_PARAMS, TP_QWEN_WHOLE_PARAMS = 7_159_441_408, 14_315_784_192
TP_QWEN_SEED, TP_QWEN_F32_LAYERS, TP_QWEN_F32_SEED = 18, 2, 181


def tp_requests(vocab: int) -> list:
    prompts, _ = serving_mix(vocab)
    return [prompts[i][:TP_PROMPT_CAP] for i in TP_REQUESTS]


def tp_prompt_lengths() -> list:
    return [len(p) for p in tp_requests(PRESETS["llama3-8b"].vocab_size)]


def tp_reference(eng, state) -> dict:
    """Phase 27's one-card reference on phase 3's engine (its prefix cache
    emptied): the greedy streams of ``tp_requests``, each stream's logits
    at every position ([TP_NEW, V]: row j after the prompt and the stream's
    first j tokens; row 0 from the prompt alone, the rest from one prefill
    of the prompt and the stream), the first-step logits of phase 4's
    prompt, the arena's bytes and the model's parameters."""
    cfg = eng.cfg
    pc = eng.kv.prefix_cache
    pc.evict(pc.cached_pages)
    prompts = tp_requests(cfg.vocab_size)
    streams = eng.generate(prompts, max_new_tokens=TP_NEW)
    stream_logits = []
    for prompt, stream in zip(prompts, streams):
        pc.evict(pc.cached_pages)
        first = prompt_logits(eng, prompt)[None]
        pc.evict(pc.cached_pages)
        rest = prompt_logits(eng, prompt + stream[:-1], keep_from=len(prompt))
        stream_logits.append(torch.cat([first, rest]).cpu().numpy())
    pc.evict(pc.cached_pages)
    logits = first_step_logits(eng, parity_prompt(cfg.vocab_size)).cpu().numpy()
    return {"streams": streams, "stream_logits": stream_logits, "logits": logits, "arena_bytes": arena_bytes(eng),
            "n_params": sum(v.numel() for v in state.values())}


def tp_rank_engine(layers: int, dtype: torch.dtype, seed: int, num_pages: int):
    """This rank's slices of ``llama3_8b(layers, dtype, seed)`` (each tensor
    drawn whole from the seeded generator, the rank's slice kept) behind a
    ``tensor_parallel`` engine with phase 3's settings; the engine, its
    parameter bytes and the seconds it took."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(PRESETS["llama3-8b"], num_hidden_layers=layers, dtype=dtype, param_dtype=dtype,
                              attention_impl="flash")
    model = LlamaForCausalLMWithCache(cfg, page_size=PAGE, device="cuda", tensor_parallel=TP_SIZE)
    init_weights_(model, torch.Generator(device="cuda").manual_seed(seed))
    state = model.state_dict()
    eng = build_engine(cfg, state, tp_econf(engine_config(dtype, num_pages)), device="cuda")
    del model, state
    return eng, sum(p.numel() * p.element_size() for p in eng.model.parameters()), time.perf_counter() - t0


def rank_tp_engine(cfg, state: dict, num_pages: int, t0: float):
    """A ``tensor_parallel`` engine with phase 27's settings over ``state``
    (whole tensors are cut to the rank's slices by the engine); the engine,
    its parameter bytes and the seconds since ``t0``."""
    econf = tp_econf(engine_config(cfg.param_dtype, num_pages))
    eng = build_engine(dataclasses.replace(cfg, attention_impl="flash"), state, econf, device="cuda")
    return eng, sum(p.numel() * p.element_size() for p in eng.model.parameters()), time.perf_counter() - t0


def tp_econf(econf):
    """``econf`` over TP_SIZE tensor-parallel ranks, its batch phase 27's 4
    requests (a step pads to 4 rows, not 8)."""
    econf = dataclasses.replace(econf, tensor_parallel=TP_SIZE)
    return dataclasses.replace(econf, scheduler=dataclasses.replace(econf.scheduler, max_seqs=TP_BATCH,
                                                                    decode_bucket=TP_BATCH))


def qwen_rank_engine(hf: dict, dtype: torch.dtype, seed: int, num_pages: int):
    """This rank's slices of the seeded Qwen2-MoE of ``hf``, made one tensor
    at a time (``qwen_rank_state``), behind ``rank_tp_engine``."""
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel
    from deepspeed_tpu_torch.comm import comm
    t0 = time.perf_counter()
    cfg, state = qwen_rank_state(hf, dtype, seed, TensorParallel(TP_SIZE, comm.get_rank() % TP_SIZE))
    return rank_tp_engine(cfg, state, num_pages, t0)


def qwen_whole_engine(hf: dict, dtype: torch.dtype, seed: int, num_pages: int):
    """The whole seeded Qwen2-MoE of ``hf`` through ``Qwen2MoePolicy.convert``
    behind ``rank_tp_engine``: the engine cuts the whole banks, biases and
    shared experts to the rank's slices (the path a user's checkpoint takes)."""
    t0 = time.perf_counter()
    policy = Qwen2MoePolicy()
    cfg = dataclasses.replace(policy.build_config(hf), dtype=dtype, param_dtype=dtype)
    return rank_tp_engine(cfg, policy.convert(seeded_hf_state(hf_shapes(hf), dtype, seed), cfg), num_pages, t0)


def first_attention(model):
    """The first block's attention (under ``layers`` or Falcon's ``h``)."""
    block = (model.layers if hasattr(model, "layers") else model.h)[0]
    return block.self_attention if hasattr(block, "self_attention") else block.self_attn


def tp_serve_bf16(make_engine=None, after=None) -> dict:
    """Phase 27(a) on one rank: the engine ``make_engine()`` gives (Llama-3-8B
    bf16 at full depth over tensor 2 by default), ``tp_requests`` stepped to
    the end (prefill tok/s up to the last first token; a decode round's ms
    over the pure-decode steps' forwards), then phase 4's first-step
    logits; ``after(eng)``'s result under ``after`` before the engine goes."""
    from deepspeed_tpu_torch.comm import comm
    acc = get_accelerator()
    eng, param_bytes, build_s = (make_engine or (lambda: tp_rank_engine(32, torch.bfloat16, 0, 1024)))()
    cfg = eng.cfg
    eng.generate([list(range(1, 20))], max_new_tokens=1)   # warm-up (one prefill step): cuBLAS, allocator
    prompts = tp_requests(cfg.vocab_size)
    uids = list(range(len(prompts)))
    # the logits each request's tokens were sampled from, in order (the steps are eager here: a fused
    # decode dispatch samples once a round, its row i the i-th sequence's)
    sampled, step_logits = [], {u: [] for u in uids}
    sample, complete = eng._sample, eng.complete_step

    def sample_rows(row_logits):
        sampled.append(row_logits.float().cpu().numpy())
        return sample(row_logits)

    def complete_step(inf):
        out = complete(inf)
        rows = inf.rows if inf.kind == "single" else [(s.uid, None, s, i) for i, s in enumerate(inf.seqs)]
        for uid, _, _, i in rows:
            step_logits[uid] += [sampled[m][i] for m in range(len(out.get(uid, [])))]
        sampled.clear()
        return out

    eng._sample, eng.complete_step = sample_rows, complete_step
    acc.synchronize()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    comm.tensor_parallel_kinds.clear()
    eng.forward_calls = 0
    t0 = time.perf_counter()
    eng.put(uids, prompts, max_new_tokens=TP_NEW)
    first, decode_s, decode_forwards = {}, 0.0, 0
    while not all(eng.state.seqs[u].done for u in uids):
        ts, f0 = time.perf_counter(), eng.forward_calls
        out = eng.step()
        now = time.perf_counter()
        if len(first) == len(uids):
            decode_s += now - ts
            decode_forwards += eng.forward_calls - f0
        for uid in out:
            first.setdefault(uid, now)
    launches, forwards = paged_attention_cuda.launches, eng.forward_calls
    kinds = {f"{k}_{d}": n for (k, d), n in comm.tensor_parallel_kinds.items()}
    streams = [list(eng.state.seqs[u].generated) for u in uids]
    for u in uids:
        eng.flush(u)
    peak = acc.max_memory_allocated() / 1e9
    logits = first_step_logits(eng, parity_prompt(cfg.vocab_size)).cpu().numpy()
    res = {"streams": streams, "step_logits": [np.stack(step_logits[u]) for u in uids], "logits": logits,
           "param_bytes": param_bytes,
           "n_params": sum(p.numel() for p in eng.model.parameters()), "arena_bytes": arena_bytes(eng),
           "heads": (first_attention(eng.model).n_heads, first_attention(eng.model).n_kv),
           "forwards": forwards, "k3_launches": launches, "k3_split_calls": paged_attention_cuda.split_calls,
           "collectives": kinds, "collectives_per_forward": {k: n / forwards for k, n in kinds.items()},
           "prefill_tok_s": sum(map(len, prompts)) / (max(first.values()) - t0),
           "decode_round_ms": 1e3 * decode_s / decode_forwards if decode_forwards else None,
           "peak_mem_gb": peak, "build_s": build_s, "serve_s": time.perf_counter() - t0}
    if after is not None:
        res["after"] = after(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_serve_f32(make_engine=None) -> dict:
    """Phase 27(a)'s float32 check on one rank: the engine ``make_engine()``
    gives (phase 4's float32 model, 2 layers, seed 1, over tensor 2 by
    default), the greedy stream of phase 4's first prompt and the
    first-step logits of its parity prompt."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng, _, _ = (make_engine or (lambda: tp_rank_engine(2, torch.float32, 1, 256)))()
    streams = eng.generate(parity_f32_prompts(eng.cfg.vocab_size)[:1], max_new_tokens=24)
    logits = first_step_logits(eng, parity_prompt(eng.cfg.vocab_size)).cpu().numpy()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"streams": streams, "logits": logits, "seconds": time.perf_counter() - t0}


def stream_ties(streams: dict, ref: dict) -> list:
    """Per request whose stream leaves one card's: the position, and whether
    it is a bf16 rounding tie — the two tokens within BF16_TIE_ULPS ulps of
    the best logit on both paths' logits of the context before it
    (``greedy_ties``'s rule; the contexts are equal up to there)."""
    out = []
    for i, (s, r) in enumerate(zip(streams["streams"], ref["streams"])):
        j = next((j for j, (a, b) in enumerate(zip(s, r)) if a != b), None)
        if j is None:
            continue
        tie = True
        for logits in (streams["step_logits"][i][j], ref["stream_logits"][i][j]):
            top = float(logits.max())
            tie = tie and min(logits[s[j]], logits[r[j]]) >= top - BF16_TIE_ULPS * bf16_ulp(top)
        out.append({"request": i, "position": j, "tokens": [s[j], r[j]], "tie": bool(tie)})
    return out


def phase_tensor_parallel_serving(smi: str, ranks: list, ref: dict, ref_f32: dict, parity: dict) -> tuple:
    """Phase 27(a): phase 11's two ranks served Llama-3-8B over tensor 2
    (``ranks``: each one's ``tp_serve_bf16`` and ``tp_serve_f32``); their
    figures and checks against phase 3's and phase 4's one-card references,
    and their K3 launches.  The first-step
    logits are held as phase 4 holds its kernel path (e its plain path's
    bf16 rounding error): within 2·e of one card's bf16 logits and 1.5·e of
    float32."""
    bf16, f32 = [r["bf16"] for r in ranks], [r["f32"] for r in ranks]
    r0 = bf16[0]
    layers = PRESETS["llama3-8b"].num_hidden_layers
    per_forward = {"embed_forward": 1.0, "o_proj_forward": float(layers), "down_proj_forward": float(layers),
                   "logits_forward": 1.0}
    e = parity["plain_vs_f32"]
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    logits_rel, logits_rel_f32 = rel(r0["logits"], ref["logits"]), rel(r0["logits"], parity["f32_logits"])
    ties = stream_ties(r0, ref)
    f32_dev = float(np.abs(f32[0]["logits"] - ref_f32["logits"]).max() / np.abs(ref_f32["logits"]).max())
    checks = {
        "tp_serve_rank_param_bytes_reckoned": all(r["param_bytes"] == 2 * TP_RANK_PARAMS_8B for r in bf16),
        "tp_serve_whole_params": ref["n_params"] == TP_WHOLE_PARAMS_8B,
        "tp_serve_tokens_equal_on_ranks": all(r["streams"] == r0["streams"] for r in bf16),
        "tp_serve_first_tokens_equal_one_card_but_ties": all(t["tie"] for t in ties if t["position"] == 0),
        "tp_serve_streams_equal_one_card_but_ties": all(t["tie"] for t in ties),
        "tp_serve_16_tokens_each": all(len(s) == TP_NEW for s in r0["streams"]),
        "tp_serve_logits_within_2e_of_one_card": logits_rel <= 2 * e,
        "tp_serve_logits_within_1.5e_of_f32": logits_rel_f32 <= 1.5 * e,
        "tp_serve_arena_half_one_card": all(2 * r["arena_bytes"] == ref["arena_bytes"] for r in bf16),
        "tp_serve_heads_16_4": all(r["heads"] == (16, 4) for r in bf16),
        "tp_serve_k3_layers_x_forwards": all(r["k3_launches"] == layers * r["forwards"] > 0 for r in bf16),
        "tp_serve_k3_split_route_taken": all(r["k3_split_calls"] > 0 for r in bf16),
        "tp_serve_collectives_per_forward": all(r["collectives_per_forward"] == per_forward for r in bf16),
        "tp_serve_f32_streams_equal_one_card": all(r["streams"] == ref_f32["streams"][:1] for r in f32),
        "tp_serve_f32_logits_1e-4": f32_dev <= TP_F32_LOGITS_TOL,
    }
    res = {"config": f"Llama-3-8B bf16, full depth, tensor {TP_SIZE} (gloo ranks on one card), {len(TP_REQUESTS)} "
                     f"of phase 3's requests (prompts cut to {TP_PROMPT_CAP} tokens), {TP_NEW} new tokens each",
           "rank_param_bytes": r0["param_bytes"], "rank_params": r0["n_params"], "whole_params": ref["n_params"],
           "arena_bytes": r0["arena_bytes"], "one_card_arena_bytes": ref["arena_bytes"],
           "peak_mem_gb": [r["peak_mem_gb"] for r in bf16], "forwards": r0["forwards"],
           "k3_launches": [r["k3_launches"] for r in bf16], "k3_split_calls": [r["k3_split_calls"] for r in bf16],
           "collectives_per_forward": r0["collectives_per_forward"],
           "streams_equal_one_card": r0["streams"] == ref["streams"],
           "first_tokens": [s[0] for s in r0["streams"]], "one_card_first_tokens": [s[0] for s in ref["streams"]],
           "stream_ties": ties, "logits_rel_l2": logits_rel, "logits_rel_l2_f32": logits_rel_f32,
           "logits_max_abs": float(np.abs(r0["logits"] - ref["logits"]).max()), "bf16_rounding_measure": e,
           "f32_logits_max_abs_over_max": f32_dev,
           "gloo_on_one_card_prefill_tok_s": [r["prefill_tok_s"] for r in bf16],
           "gloo_on_one_card_decode_round_ms": [r["decode_round_ms"] for r in bf16],
           "build_s": [r["build_s"] for r in bf16], "serve_s": [r["serve_s"] for r in bf16],
           "f32_s": [r["seconds"] for r in f32], "card": smi}
    launches = sum(r["k3_launches"] for r in bf16)
    return res, checks, launches


def phase_tensor_parallel_qwen(smi: str, ranks: list, ref: dict, ref_f32: dict, e: float) -> tuple:
    """Phase 27(a)'s Qwen1.5-MoE-A2.7B over tensor 2 on phase 11's ranks
    (``ranks``: each one's ``tp_serve_bf16`` and ``tp_serve_f32`` of it),
    held to phase 18's one-card engine (``ref``: its ``tp_reference``) and
    float32 references (``ref_f32``); ``e`` is phase 18's bf16 rounding
    measure of the plain path against float32."""
    bf16, f32 = [r["bf16"] for r in ranks], [r["f32"] for r in ranks]
    r0 = bf16[0]
    layers = QWEN_MOE["num_hidden_layers"]
    per_forward = {"embed_forward": 1.0, "o_proj_forward": float(layers), "moe_forward": float(layers),
                   "logits_forward": 1.0}
    logits_rel = float(np.linalg.norm(r0["logits"] - ref["logits"]) / np.linalg.norm(ref["logits"]))
    ties = stream_ties(r0, ref)
    f32_dev = float(np.abs(f32[0]["logits"] - ref_f32["logits"]).max() / np.abs(ref_f32["logits"]).max())
    checks = {
        "tp_qwen_rank_param_bytes_reckoned": all(r["param_bytes"] == 2 * TP_QWEN_RANK_PARAMS for r in bf16),
        "tp_qwen_rank_params_reckoned": all(r["n_params"] == TP_QWEN_RANK_PARAMS for r in bf16),
        "tp_qwen_whole_params": ref["n_params"] == TP_QWEN_WHOLE_PARAMS,
        "tp_qwen_tokens_equal_on_ranks": all(r["streams"] == r0["streams"] for r in bf16),
        "tp_qwen_streams_equal_one_card_but_ties": all(t["tie"] for t in ties),
        "tp_qwen_16_tokens_each": all(len(s) == TP_NEW for s in r0["streams"]),
        "tp_qwen_logits_within_2e_of_one_card": logits_rel <= 2 * e,
        "tp_qwen_arena_half_one_card": all(2 * r["arena_bytes"] == ref["arena_bytes"] for r in bf16),
        "tp_qwen_heads_8_8": all(r["heads"] == (8, 8) for r in bf16),
        "tp_qwen_k3_layers_x_forwards": all(r["k3_launches"] == layers * r["forwards"] > 0 for r in bf16),
        "tp_qwen_collectives_per_forward": all(r["collectives_per_forward"] == per_forward for r in bf16),
        "tp_qwen_f32_streams_equal_one_card": all(r["streams"] == ref_f32["streams"] for r in f32),
        "tp_qwen_f32_logits_1e-4": f32_dev <= TP_F32_LOGITS_TOL,
    }
    res = {"config": f"Qwen1.5-MoE-A2.7B bf16, full width and depth, tensor {TP_SIZE} (gloo ranks on one card), "
                     f"{len(TP_REQUESTS)} of phase 3's requests (prompts cut to {TP_PROMPT_CAP} tokens), {TP_NEW} "
                     "new tokens each", "rank_param_bytes": r0["param_bytes"], "rank_params": r0["n_params"],
           "whole_params": ref["n_params"], "arena_bytes": r0["arena_bytes"],
           "one_card_arena_bytes": ref["arena_bytes"], "heads": r0["heads"],
           "peak_mem_gb": [r["peak_mem_gb"] for r in bf16], "forwards": r0["forwards"],
           "k3_launches": [r["k3_launches"] for r in bf16], "k3_split_calls": [r["k3_split_calls"] for r in bf16],
           "collectives_per_forward": r0["collectives_per_forward"],
           "streams_equal_one_card": r0["streams"] == ref["streams"], "stream_ties": ties,
           "logits_rel_l2": logits_rel, "bf16_rounding_measure": e, "f32_logits_max_abs_over_max": f32_dev,
           "gloo_on_one_card_prefill_tok_s": [r["prefill_tok_s"] for r in bf16],
           "gloo_on_one_card_decode_round_ms": [r["decode_round_ms"] for r in bf16],
           "build_s": [r["build_s"] for r in bf16], "serve_s": [r["serve_s"] for r in bf16],
           "f32_s": [r["seconds"] for r in f32], "card": smi}
    return res, checks, sum(r["k3_launches"] for r in bf16)


# ---------------------------------------------------------------- phase 27(a): the dense zoo and the v1 engine

#: Phi-2 over tensor 2 at full width and depth: a rank's parameters (each block's LayerNorm, the ``dense`` and
#: ``fc2`` biases and the final LayerNorm whole, the rest halved, the head's bias with the vocab), the whole
#: model's, and the seed of its HF tensors (``seeded_hf_state``'s draws)
TP_PHI2_RANK_PARAMS, TP_PHI2_WHOLE_PARAMS, TP_PHI2_SEED = 1_390_008_320, 2_779_683_840, 27
#: phase 17's checkpoints served again over tensor 2 from their directories (kept until phase 27(a))
TP_ZOO = ("falcon-rw-1b", "opt-6.7b")
#: the v1 engine over tensor 2 (pythia-6.9b, phase 21's weights): a rank's parameters (the LayerNorms and the
#: two row-parallel biases of each block whole, the rest halved) of the whole model's; phase 21's first prompt
#: cut to V1_TP_PROMPT_LEN tokens and V1_TP_NEW new ones, a [1, 128] buffer (``generate`` recomputes the whole
#: buffer a token, 2 x 32 gloo all-reduces a forward; a length that 128 does not divide takes the chunked
#: attention, as JAX's op dispatches, not K1)
V1_TP_RANK_PARAMS, V1_TP_WHOLE_PARAMS = 3_429_048_320, 6_857_302_016
V1_TP_PROMPT_LEN, V1_TP_NEW = 120, 8


def phi2_rank_state(dtype, seed: int, tp) -> tuple:
    """Tensor-parallel rank ``tp.rank``'s slices of the seeded Phi-2
    (``seeded_hf_state(hf_shapes(ZOO["phi-2"]), dtype, seed)`` through
    ``PhiPolicy``): each HF tensor drawn whole from the same generator in
    the same order and cut to the rank's slice at once, so a rank never
    holds the whole model (``tp`` of one rank: the whole model).  Returns
    (config, state dict)."""
    from deepspeed_tpu_torch.module_inject.layers import narrow_to_rank, tp_dims
    hf, policy = ZOO["phi-2"][0], policy_for("phi")
    cfg = dataclasses.replace(policy.build_config(hf), dtype=dtype, param_dtype=dtype)
    cut = tp_dims(build_cache_model(cfg, PAGE, device="meta", tensor_parallel=tp.size)) if tp.size > 1 else {}
    shapes = hf_shapes(hf)
    # the port's name of each HF tensor: the policy's own mapping, run on meta tensors
    meta = {name: torch.empty(shape, device="meta") for name, shape in shapes.items()}
    port_of = {id(t): k for k, t in policy.convert(meta, cfg).items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = {}
    for name, shape in shapes.items():
        whole = seeded_hf_tensor(name, shape, dtype, gen)
        port = port_of[id(meta[name])]
        state[port] = narrow_to_rank(whole, cut[port], tp).clone() if port in cut else whole
    return cfg, state


def phi2_tp_reference() -> dict:
    """Phase 27(a)'s one-card Phi-2 (bf16, full width and depth, phase 3's
    engine settings), served by the parent before phase 11's spawn:
    ``tp_reference`` of the weights the ranks cut."""
    from deepspeed_tpu_torch.module_inject.layers import NO_TENSOR_PARALLEL
    t0 = time.perf_counter()
    cfg, state = phi2_rank_state(torch.bfloat16, TP_PHI2_SEED, NO_TENSOR_PARALLEL)
    eng = build_engine(dataclasses.replace(cfg, attention_impl="flash"), state, engine_config(torch.bfloat16, 1024),
                       device="cuda")
    ref = tp_reference(eng, state)
    ref["seconds"] = time.perf_counter() - t0
    del eng, state
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def phi2_rank_engine():
    """This rank's slices of the seeded Phi-2 (``phi2_rank_state``) behind
    ``rank_tp_engine``."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel
    t0 = time.perf_counter()
    cfg, state = phi2_rank_state(torch.bfloat16, TP_PHI2_SEED, TensorParallel(TP_SIZE, comm.get_rank() % TP_SIZE))
    return rank_tp_engine(cfg, state, 1024, t0)


def zoo_dir_tp_engine(path: str):
    """Phase 17's checkpoint directory through ``build_hf_engine`` over
    tensor 2 (phase 17's engine settings, phase 27's batch): the engine
    splits Falcon's fused ``query_key_value`` and cuts every whole tensor
    to the rank's slices."""
    t0 = time.perf_counter()
    eng = build_hf_engine(path, tp_econf(engine_config(torch.bfloat16, 1024, ZOO_MAX_PAGES)), device="cuda")
    return eng, sum(p.numel() * p.element_size() for p in eng.model.parameters()), time.perf_counter() - t0


def zoo_f32_tp_streams(name: str, eng) -> dict:
    """The rank's slices in float32 (TF32 off) behind a tensor-2 engine with
    phase 17's float32 settings: the greedy streams of phase 17's float32
    prompts (``zoo_parity_f32``'s)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(eng.cfg, dtype=torch.float32, param_dtype=torch.float32, attention_impl="flash")
    state = {k: v.float() for k, v in eng.model.state_dict().items()}
    econf = dataclasses.replace(engine_config(torch.float32, 512, ZOO_MAX_PAGES), tensor_parallel=TP_SIZE)
    f32 = build_engine(cfg, state, econf, device="cuda")
    prompts = zoo_f32_prompts(name, cfg.vocab_size)
    streams = serve_greedy(f32, prompts, [12] * len(prompts))
    del f32, state
    return {"f32_streams": streams, "f32_s": time.perf_counter() - t0}


def falcon_7b_tp_error() -> str:
    """Falcon-7B's 71 query heads on one kv head at tensor 2: the engine's
    error (JAX's ``_setup_tp`` text), or None if it builds."""
    cfg = dataclasses.replace(FalconPolicy().build_config(FALCON_7B), dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    try:
        build_engine(cfg, {}, tp_econf(engine_config(torch.bfloat16, 16)), device="cuda")
    except ValueError as e:
        return str(e)
    return None


def v1_tp_rank(ref: dict) -> dict:
    """The v1 engine over tensor 2 on one rank: phase 21's pythia-6.9b (the
    same seeded bf16 weights, made whole and cut by the engine after kernel
    injection) through ``init_inference(model, tensor_parallel=2,
    replace_with_kernel_inject=True)``; the last-position logits of phase
    21's first buffer row, a greedy run over ``ref``'s short buffer and its
    logits at each new position, K1 launches and the collectives."""
    from deepspeed_tpu_torch.comm import comm
    t0 = time.perf_counter()
    cfg = gpt_family.GPTNeoXConfig.from_hf(PYTHIA_6_9B, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = seed_weights_(gpt_family.GPTNeoXForCausalLM(cfg, device="cuda"), seed=22)
    eng = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"}, tensor_parallel=TP_SIZE,
                                             replace_with_kernel_inject=True, device="cuda")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    heads = eng.module.layers[0].query_key_value.out_features // (3 * cfg.head_dim)
    reset_launch_counts()
    comm.tensor_parallel_kinds.clear()
    t0 = time.perf_counter()
    logits = eng.forward(torch.from_numpy(ref["ids"]).cuda())[:, -1].float().cpu().numpy()
    forward_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens = eng.generate(ref["short_prompt"], max_new_tokens=V1_TP_NEW)
    generate_s = time.perf_counter() - t0
    step_logits = eng.forward(torch.from_numpy(tokens).cuda())[0, V1_TP_PROMPT_LEN - 1:-1].float().cpu().numpy()
    forwards = 2 + V1_TP_NEW
    kinds = {f"{k}_{d}": n for (k, d), n in comm.tensor_parallel_kinds.items()}
    res = {"logits": logits, "tokens": tokens, "step_logits": step_logits, "k1_launches": flash_fwd_cuda.launches,
           "forwards": forwards, "heads": heads, "impl": eng.module.cfg.attention_impl,
           "n_params": sum(p.numel() for p in eng.module.parameters()),
           "collectives_per_forward": {k: n / forwards for k, n in kinds.items()}, "build_s": build_s,
           "forward_s": forward_s, "generate_s": generate_s}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_zoo_rank(inputs: dict) -> dict:
    """Phase 27(a)'s dense zoo and v1 engine on one of phase 11's ranks:
    Phi-2 at full depth (``phi2_rank_engine``), phase 17's Falcon-RW-1B and
    OPT-6.7B directories (bf16, then their float32 streams), Falcon-7B's
    refusal, then pythia-6.9b through the v1 engine."""
    out = {"phi-2": tp_serve_bf16(phi2_rank_engine)}
    for name in TP_ZOO:
        path = inputs["dirs"][name]
        out[name] = tp_serve_bf16(lambda path=path: zoo_dir_tp_engine(path),
                                  after=lambda eng, name=name: zoo_f32_tp_streams(name, eng))
    out["falcon-7b_error"] = falcon_7b_tp_error()
    out["v1"] = v1_tp_rank(inputs["v1"])
    return out


def v1_stream_ties(got: dict, ref: dict) -> list:
    """Where a rank's short greedy buffer leaves one card's: the position,
    and whether it is a bf16 rounding tie (both tokens within BF16_TIE_ULPS
    ulps of the best logit on both paths' logits there)."""
    s0 = V1_TP_PROMPT_LEN
    a, b = got["tokens"][0, s0:].tolist(), ref["short_tokens"][0, s0:].tolist()
    j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        return []
    tie = True
    for logits in (got["step_logits"][j], ref["short_logits"][j]):
        top = float(logits.max())
        tie = tie and min(logits[a[j]], logits[b[j]]) >= top - BF16_TIE_ULPS * bf16_ulp(top)
    return [{"position": j, "tokens": [a[j], b[j]], "tie": bool(tie)}]


def tp_zoo_serving_checks(tag: str, bf16: list, ref: dict, layers: int, heads: tuple) -> dict:
    """A family's phase 27(a) checks over tensor 2 against its one-card
    reference (``tp_reference``): ranks' tokens equal, each stream one
    card's up to a bf16 tie, the arena half one card's, the rank's heads,
    K3 == layers × forwards, and the collectives a forward (the embedding's,
    two row-parallel all-reduces a layer, the logits gather)."""
    r0 = bf16[0]
    per_forward = {"embed_forward": 1.0, "o_proj_forward": float(layers), "down_proj_forward": float(layers),
                   "logits_forward": 1.0}
    return {f"{tag}_tokens_equal_on_ranks": all(r["streams"] == r0["streams"] for r in bf16),
            f"{tag}_streams_equal_one_card_but_ties": all(t["tie"] for t in stream_ties(r0, ref)),
            f"{tag}_16_tokens_each": all(len(s) == TP_NEW for s in r0["streams"]),
            f"{tag}_arena_half_one_card": all(2 * r["arena_bytes"] == ref["arena_bytes"] for r in bf16),
            f"{tag}_heads": all(r["heads"] == heads for r in bf16),
            f"{tag}_k3_layers_x_forwards": all(r["k3_launches"] == layers * r["forwards"] > 0 for r in bf16),
            f"{tag}_collectives_per_forward": all(r["collectives_per_forward"] == per_forward for r in bf16)}


def phase_tensor_parallel_zoo(smi: str, ranks: list, refs: dict, e: float) -> tuple:
    """Phase 27(a)'s dense zoo and v1 engine over tensor 2 on phase 11's
    ranks (``ranks``: each one's ``tp_zoo_rank``), held to their one-card
    references (``refs``: Phi-2's ``phi2_tp_reference``, phase 17's of
    TP_ZOO, phase 21's of the v1 engine); ``e`` is phase 4's bf16 rounding
    measure.  Returns the figures, the checks and the K3 and K1 launches."""
    figures = lambda runs, ref: {
        "rank_param_bytes": runs[0]["param_bytes"], "rank_params": runs[0]["n_params"],
        "whole_params": ref["n_params"], "arena_bytes": runs[0]["arena_bytes"],
        "one_card_arena_bytes": ref["arena_bytes"], "heads": runs[0]["heads"], "forwards": runs[0]["forwards"],
        "k3_launches": [r["k3_launches"] for r in runs], "k3_split_calls": [r["k3_split_calls"] for r in runs],
        "collectives_per_forward": runs[0]["collectives_per_forward"],
        "streams_equal_one_card": runs[0]["streams"] == ref["streams"], "stream_ties": stream_ties(runs[0], ref),
        "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
        "gloo_on_one_card_prefill_tok_s": [r["prefill_tok_s"] for r in runs],
        "gloo_on_one_card_decode_round_ms": [r["decode_round_ms"] for r in runs],
        "build_s": [r["build_s"] for r in runs], "serve_s": [r["serve_s"] for r in runs]}
    res, checks, k3 = {"card": smi}, {}, 0
    phi = [r["phi-2"] for r in ranks]
    ref = refs["phi-2"]
    layers = ZOO["phi-2"][0]["num_hidden_layers"]
    logits_rel = float(np.linalg.norm(phi[0]["logits"] - ref["logits"]) / np.linalg.norm(ref["logits"]))
    checks.update(tp_zoo_serving_checks("tp_phi2", phi, ref, layers, (16, 16)))
    checks.update({"tp_phi2_rank_params_reckoned": all(r["n_params"] == TP_PHI2_RANK_PARAMS for r in phi),
                   "tp_phi2_rank_param_bytes_reckoned": all(r["param_bytes"] == 2 * TP_PHI2_RANK_PARAMS for r in phi),
                   "tp_phi2_whole_params": ref["n_params"] == TP_PHI2_WHOLE_PARAMS,
                   "tp_phi2_logits_within_2e_of_one_card": logits_rel <= 2 * e})
    res["phi-2"] = {"config": f"Phi-2 bf16, full width and depth, tensor {TP_SIZE} (gloo ranks on one card), "
                              f"{len(TP_REQUESTS)} of phase 3's requests (prompts cut to {TP_PROMPT_CAP} tokens), "
                              f"{TP_NEW} new tokens each", **figures(phi, ref), "logits_rel_l2": logits_rel,
                    "bf16_rounding_measure": e, "one_card_s": ref["seconds"]}
    k3 += sum(r["k3_launches"] for r in phi)
    for name in TP_ZOO:
        runs = [r[name] for r in ranks]
        ref = refs[name]
        hf = ZOO[name][0]
        tag = "tp_" + name.split("-")[0] + ("_rw" if "rw" in name else "")
        checks.update(tp_zoo_serving_checks(tag, runs, ref, ZOO_LAYERS, (16, 16)))
        checks[f"{tag}_f32_streams_equal_one_card"] = all(r["after"]["f32_streams"] == ref["f32_streams"]
                                                          for r in runs)
        res[name] = {"config": f"{name} from phase 17's directory ({ZOO_LAYERS} of {hf['num_hidden_layers']} layers) "
                               f"through build_hf_engine at tensor {TP_SIZE}", **figures(runs, ref),
                     "f32_s": [r["after"]["f32_s"] for r in runs]}
        k3 += sum(r["k3_launches"] for r in runs)
    errors = [r["falcon-7b_error"] for r in ranks]
    res["falcon-7b_error"] = errors[0]
    checks["tp_falcon_7b_raises_jax_error"] = all(
        m is not None and "must divide num_key_value_heads=1 and num_attention_heads=71" in m for m in errors)
    v1 = [r["v1"] for r in ranks]
    vref = refs["v1"]
    ve = vref["e"]
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    v1_layers = PYTHIA_6_9B["num_hidden_layers"]
    per_forward = {"embed_forward": 1.0, "o_proj_forward": float(v1_layers), "down_proj_forward": float(v1_layers),
                   "logits_forward": 1.0}
    ties = v1_stream_ties(v1[0], vref)
    checks.update({
        "tp_v1_injected": all(r["impl"] == "flash" for r in v1),
        "tp_v1_rank_params_reckoned": all(r["n_params"] == V1_TP_RANK_PARAMS for r in v1),
        "tp_v1_whole_params": vref["n_params"] == V1_TP_WHOLE_PARAMS,
        "tp_v1_heads_16_16": all(r["heads"] == 16 for r in v1),
        "tp_v1_logits_within_2e_of_one_card": all(rel(r["logits"], vref["logits"]) <= 2 * ve for r in v1),
        "tp_v1_tokens_equal_on_ranks": all(np.array_equal(r["tokens"], v1[0]["tokens"]) for r in v1),
        "tp_v1_tokens_equal_one_card_but_ties": all(t["tie"] for t in ties),
        "tp_v1_k1_layers_x_forwards": all(r["k1_launches"] == v1_layers * r["forwards"] for r in v1),
        "tp_v1_collectives_per_forward": all(r["collectives_per_forward"] == per_forward for r in v1)})
    res["v1"] = {"config": f"pythia-6.9b bf16 (phase 21's weights) through init_inference(tensor_parallel="
                           f"{TP_SIZE}, replace_with_kernel_inject=True), gloo ranks on one card; the logits of "
                           f"phase 21's first [1, {V1_PROMPT_LEN + V1_NEW}] row, a greedy buffer of "
                           f"{V1_TP_PROMPT_LEN} + {V1_TP_NEW}",
                 "rank_params": v1[0]["n_params"], "whole_params": vref["n_params"],
                 "logits_rel_l2": [rel(r["logits"], vref["logits"]) for r in v1],
                 "logits_rel_l2_f32": [rel(r["logits"], vref["f32_logits"]) for r in v1], "bf16_rounding_measure": ve,
                 "tokens_equal_one_card": np.array_equal(v1[0]["tokens"], vref["short_tokens"]), "ties": ties,
                 "k1_launches": [r["k1_launches"] for r in v1], "forwards": v1[0]["forwards"],
                 "collectives_per_forward": v1[0]["collectives_per_forward"],
                 "build_s": [r["build_s"] for r in v1], "forward_s": [r["forward_s"] for r in v1],
                 "generate_s": [r["generate_s"] for r in v1]}
    return res, checks, k3, sum(r["k1_launches"] for r in v1)


def tp_zoo_rank_main(rank: int, init_methods, queue, tp_inputs: dict) -> None:
    """A spawned rank of ``phase_tensor_parallel_zoo_alone``: ``tp_zoo_rank``
    on two gloo ranks sharing the card."""
    from deepspeed_tpu_torch.comm import comm
    try:
        torch.cuda.set_device(0)
        comm.init_distributed(dist_backend="gloo", init_method=init_methods[None], rank=rank, world_size=TP_SIZE,
                              timeout=DP_TIMEOUT_S, verbose=False)
        queue.put((rank, tp_zoo_rank(tp_inputs), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if comm.is_initialized():
            torch.distributed.destroy_process_group()


def phase_tensor_parallel_zoo_alone(smi: str, e: float) -> dict:
    """Phase 27(a)'s dense zoo and v1 runs without phase 11's: TP_ZOO's
    directories and one-card references (phase 17's way), phase 21, the
    one-card Phi-2, then two ranks of their own; ``e`` stands for phase 4's
    bf16 rounding measure.  Raises if a check fails."""
    keep = tempfile.mkdtemp(prefix="zoo_tp_")
    try:
        refs, dirs = {}, {}
        for i, (name, (published, fmt)) in enumerate(ZOO.items()):
            if name in TP_ZOO:
                r = serve_checkpoint_dir(keep, name, published, ZOO_LAYERS, fmt, 170 + i, smi, keep=True)
                refs[name], dirs[name] = r.pop("tp_reference"), r["dir"]
        refs["v1"] = phase_v1_engine(smi).pop("tp_reference")
        refs["phi-2"] = phi2_tp_reference()
        ranks = spawn_ranks(tp_zoo_rank_main, TP_SIZE, DP_TIMEOUT_S, extra=({"dirs": dirs, "v1": refs["v1"]}, ))
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    res, checks, _, _ = phase_tensor_parallel_zoo(smi, ranks, refs, e)
    log("  tensor parallel serving of Phi-2, Falcon-RW-1B, OPT-6.7B and the v1 engine: " + json.dumps(res))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"tensor-parallel zoo serving failed {bad}")
    return res


# ---------------------------------------------------------------- phase 12

FRONTEND_REQUESTS = 16
FRONTEND_ARRIVAL_S = 2.0           # open-loop arrivals at seeded offsets over the first ~2 s
FRONTEND_ARENA_SHARE = 0.4         # device arena: ~40% of the mix's pages
FRONTEND_DEADLINE_S = 120.0        # every request's end-to-end deadline (goodput counts those met)
MIGRATION_AFTER = 8                # decoded tokens before the migration check's export


class StagingMeter:
    """Wraps one engine's ``export_pages``/``import_pages`` (instance
    attributes, so the serving stack's calls go through it): bytes and
    fenced seconds of each direction, and for every import a re-export of
    the same pages held against the imported bytes, plus whether those
    bytes are a block the tier demoted (its crc32 among the demotions')."""

    def __init__(self, engine, tier=None):
        self.kv = engine.kv
        self.export, self.import_ = engine.kv.export_pages, engine.kv.import_pages
        self.d2h_bytes = self.h2d_bytes = 0
        self.d2h_s = self.h2d_s = 0.0
        self.exports = self.imports = 0
        self.demoted_crcs = set()
        self.reexport_equal = []       # (bytes equal, the block was a demoted snapshot's)
        engine.kv.export_pages = self._export
        engine.kv.import_pages = self._import
        if tier is not None:
            demote = tier.demote_sequence

            def demote_sequence(uid):
                handle = demote(uid)
                snap = tier.host.peek_seq(uid)
                if handle is not None and snap is not None:
                    self.demoted_crcs.update(snap.crcs)
                return handle

            tier.demote_sequence = demote_sequence

    def _export(self, arena, pages):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = self.export(arena, pages)          # ends in its device -> host copy
        self.d2h_s += time.perf_counter() - t0
        self.d2h_bytes += block.nbytes
        self.exports += 1
        return block

    def _import(self, arena, pages, block):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.import_(arena, pages, block)
        torch.cuda.synchronize()
        self.h2d_s += time.perf_counter() - t0
        self.h2d_bytes += block.nbytes
        self.imports += 1
        again = self.export(out, pages)
        crc = zlib.crc32(np.ascontiguousarray(block).tobytes())
        self.reexport_equal.append((bool(np.array_equal(again, block)), crc in self.demoted_crcs))
        return out

    def rates(self) -> dict:
        return {"staged_d2h_bytes": self.d2h_bytes, "staged_h2d_bytes": self.h2d_bytes,
                "exports": self.exports, "imports": self.imports,
                "d2h_gb_s": self.d2h_bytes / self.d2h_s / 1e9 if self.d2h_s else None,
                "h2d_gb_s": self.h2d_bytes / self.h2d_s / 1e9 if self.h2d_s else None}


class StepMeter:
    """Wraps an engine's ``dispatch_step``/``complete_step``: wall seconds
    and tokens of each step from its dispatch to its readback, and whether
    it was pure decode (every row one token)."""

    def __init__(self, engine):
        self.steps = []
        dispatch, complete = engine.dispatch_step, engine.complete_step
        starts = {}

        def dispatch_step(plan=None):
            t0 = time.perf_counter()
            inf = dispatch(plan)
            if inf is not None:
                starts[id(inf)] = t0
            return inf

        def complete_step(inf):
            out = complete(inf)
            decode = inf.kind == "multi" or all(n == 1 for _, n, _, _ in inf.rows)
            self.steps.append((time.perf_counter() - starts.pop(id(inf)), sum(map(len, out.values())), decode))
            return out

        engine.dispatch_step, engine.complete_step = dispatch_step, complete_step

    def decode_tok_s(self) -> float:
        secs = sum(s for s, _, d in self.steps if d)
        return sum(n for _, n, d in self.steps if d) / secs if secs else 0.0


def frontend_mix(vocab: int, seed: int = 12) -> list:
    """16 open-loop requests: prompts of 64-1024 tokens, two pairs sharing a
    512-token prefix, 32-64 new tokens, two priority classes (every fourth
    request urgent), arrivals at seeded offsets over the first ~2 s."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1025, FRONTEND_REQUESTS)
    for i in (1, 3, 9, 11):
        lens[i] = max(lens[i], 600)             # long enough to share a 512-token prefix
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in lens]
    prompts[3] = prompts[1][:512] + prompts[3][512:]
    prompts[11] = prompts[9][:512] + prompts[11][512:]
    arrivals = np.sort(rng.uniform(0.0, FRONTEND_ARRIVAL_S, FRONTEND_REQUESTS))
    return [dict(prompt=p, max_new_tokens=int(rng.integers(32, 65)), arrival_ts=float(t),
                 priority=0.0 if i % 4 == 0 else 1.0, deadline=float(t) + FRONTEND_DEADLINE_S)
            for i, (p, t) in enumerate(zip(prompts, arrivals))]


def migration_check(cfg, state, rng) -> dict:
    """One request alone on its own engine (the same weights, no prefix
    cache): generated by the bare engine, then served, migrated out after
    ``MIGRATION_AFTER`` tokens (``begin_migration`` → every chunk exported →
    ``complete_migration``) and resubmitted with its ``kv_snapshot``.  Both
    runs are batch 1 with the same shapes; the tokens must be equal."""
    econf = dataclasses.replace(engine_config(torch.bfloat16, 128), enable_prefix_cache=False,
                                decode_steps_per_dispatch=1)
    eng = build_engine(cfg, state, econf, device="cuda")
    prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
    golden = eng.generate([prompt], max_new_tokens=40)[0]
    meter = StagingMeter(eng)
    serve = ServingEngine(eng, clock=WallClock())
    req = serve.submit(prompt, max_new_tokens=40)
    for _ in range(200):
        if req.state is RequestState.DECODE and len(req.tokens) >= MIGRATION_AFTER:
            break
        serve.tick()
    exporter = serve.begin_migration(req.uid, chunk_pages=8)
    if exporter is None:
        raise AssertionError(f"migration refused in state {req.state} with {len(req.tokens)} tokens")
    while not exporter.step_chunk():
        pass
    snap = exporter.snapshot
    serve.complete_migration(req.uid)
    again = serve.submit(prompt, max_new_tokens=40, resume_tokens=list(req.tokens), kv_snapshot=snap)
    serve.drain()
    res = {"tokens_equal": list(again.tokens) == golden, "migrated_after": len(req.tokens),
           "snapshot_pages": snap.n_pages, "snapshot_bytes": snap.n_bytes, "snapshot_dtype": snap.dtype,
           "kv_imports": serve.stats.kv_imports, "reexport_equal": all(e for e, _ in meter.reexport_equal),
           "forwards": eng.forward_calls, **meter.rates()}
    del serve, eng
    return res


def phase_serving_frontend(cfg, state, smi: str) -> dict:
    """The serving stack above the engine: ``ServingEngine`` (wall clock) on
    ``build_engine`` with a ``TieredKVManager``, 16 open-loop requests of
    two priority classes into a device arena of ~40% of the mix's pages, so
    KV pressure preempts by demoting to the host tier and re-admission
    promotes back; then the migration check."""
    layers = cfg.num_hidden_layers
    mix = frontend_mix(cfg.vocab_size)
    demand = sum(-(-(len(a["prompt"]) + a["max_new_tokens"]) // PAGE) for a in mix)
    num_pages = int(FRONTEND_ARENA_SHARE * demand) + 1
    econf = dataclasses.replace(engine_config(torch.bfloat16, num_pages), decode_steps_per_dispatch=1)
    eng = build_engine(cfg, state, econf, device="cuda")
    eng.generate([list(range(1, 20))], max_new_tokens=9)   # warm-up: cuBLAS handles, allocator
    eng.kv.prefix_cache.evict(eng.kv.prefix_cache.cached_pages)
    tier = TieredKVManager(eng, config=TierConfig(host_capacity_pages=4 * num_pages))
    staging = StagingMeter(eng, tier)
    steps = StepMeter(eng)
    clock = WallClock()
    serve = ServingEngine(eng, clock=clock)
    serve.attach_tier(tier)
    page_bytes = sum(t[0].numel() * t.element_size() for t in eng.cache)

    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    eng.forward_calls = 0
    clock.reset()
    serve.rebase_epoch()
    t0 = time.perf_counter()
    reqs = serve.run(mix)
    wall = time.perf_counter() - t0
    launches, forwards = paged_attention_cuda.launches, eng.forward_calls
    peak = acc.max_memory_allocated() / 1e9

    summary = serve.summary()
    pc = eng.kv.prefix_cache
    host_used = tier.host.pages_used
    by_class = {}
    for prio in (0.0, 1.0):
        ttfts = [r.ttft for r, a in zip(reqs, mix) if a["priority"] == prio and r.ttft is not None]
        by_class[f"priority_{prio:g}_ttft_s_p50"] = float(np.percentile(ttfts, 50)) if ttfts else None
    checks = {
        "all_done_with_their_tokens": all(r.state is RequestState.DONE and len(r.tokens) == a["max_new_tokens"]
                                          for r, a in zip(reqs, mix)),
        "demoted_and_promoted": tier.stats["demotions"] >= 1 and tier.stats["promotions"] >= 1,
        "promoted_reexport_equals_demoted_bytes": bool(staging.reexport_equal) and all(
            e for e, _ in staging.reexport_equal) and any(d for _, d in staging.reexport_equal),
        "pages_accounted": not eng.state.seqs and eng.kv.allocator.free_pages + pc.cached_pages == num_pages - 1,
        "host_tier_accounted": not serve._parked and host_used == sum(tier.host._lru.values())
        and host_used <= tier.host.capacity_pages,
        "k3_launches_layers_x_forwards": launches == layers * forwards and launches > 0,
    }
    reset_launch_counts()
    migration = migration_check(cfg, state, np.random.default_rng(13))
    mig_launches = paged_attention_cuda.launches
    checks["migration_tokens_equal"] = migration["tokens_equal"] and migration["kv_imports"] == 1 \
        and migration["reexport_equal"]
    checks["migration_k3_launches"] = mig_launches == layers * migration["forwards"]
    res = {"card": smi, "requests": len(reqs), "prompt_tokens": sum(len(a["prompt"]) for a in mix),
           "generated": sum(len(r.tokens) for r in reqs), "arena_pages": num_pages, "mix_pages": demand,
           "page_bytes": page_bytes, "ttft_s": {k: summary["ttft"][k] for k in ("p50", "p99")},
           "tpot_s": {k: summary["tpot"][k] for k in ("p50", "p99")}, **by_class,
           "goodput_rps": summary["goodput_rps"], "decode_tok_s": steps.decode_tok_s(),
           "output_tok_s": sum(len(r.tokens) for r in reqs) / wall, "preemptions": summary["preemptions"],
           "demotions": tier.stats["demotions"], "promotions": tier.stats["promotions"],
           "prefix_demotions": tier.stats["prefix_demotions"], "prefix_promotions": tier.stats["prefix_promotions"],
           "kv_imports": summary["kv_imports"], "kv_import_fallbacks": summary["kv_import_fallbacks"],
           **staging.rates(), "host_pages_after": host_used, "steps": len(steps.steps), "forwards": forwards,
           "k3_launches": launches, "wall_s": wall, "peak_mem_gb": peak, "migration": migration,
           "migration_k3_launches": mig_launches, "checks": checks}
    log("  serving frontend: " + json.dumps(res))
    del serve, tier, eng
    gc.collect()
    torch.cuda.empty_cache()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"serving-frontend phase failed {bad}")
    return res


# ---------------------------------------------------------------- phase 13

SPEC_MAX_DRAFT = 4
STEP_SET = [(8, 1), (8, 256), ("multi", 8, 2), ("multi", 8, 4), ("multi", 8, 8), ("verify", 8, SPEC_MAX_DRAFT + 1)]
# a token whose two best logits are closer than this share of its best
# logit is a rounding tie: the verify forward's GEMMs take other shapes than
# the decode forward's, so float32 sums may round the other way there
TIE_MARGIN = 1e-4
# in bfloat16 the spec stream may leave the plain one only for a token whose
# logit lies within this many bf16 ulps of the best one: the cache-free model
# that judges it is a bf16 computation too, and orders candidates that close
# (two or three of them) otherwise than either engine
BF16_TIE_ULPS = 4


def pattern_prompts(vocab: int, seed: int = 21) -> list:
    """Two prompts that repeat a 32-token pattern (4 and 6 times), so the
    n-gram drafter proposes from the first decode round on."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 32).tolist() * n for n in (4, 6)]


def graph_pool_bytes(pool) -> int:
    """Bytes of the caching allocator's segments that belong to a graph pool."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot() if tuple(s["segment_pool_id"]) == tuple(pool))


def key_batches(eng, prompts, max_new, rng) -> dict:
    """One real packed batch per step-set key, packed without advancing the
    engine: phase 3's 8 prompts prefilled to their first token (decode, the
    fused rounds, verify with 4 random draft tokens a row) and 8 fresh
    prompts' first 256-token chunk."""
    vocab = eng.cfg.vocab_size
    for uid, (p, n) in enumerate(zip(prompts, max_new)):
        eng.put([uid], [p], max_new_tokens=n)
    while not all(s.in_decode for s in eng.state.seqs.values()):
        eng.step()
    eng.put(list(range(100, 108)), [rng.integers(0, vocab, 300).tolist() for _ in range(8)], max_new_tokens=8)
    decode = [eng.state.seqs[u] for u in range(8)]
    fresh = [eng.state.seqs[u] for u in range(100, 108)]
    out = {}
    for key in STEP_SET:
        if key[0] == "multi":
            for s in decode:
                eng.kv.ensure_capacity(s, key[2])
            rb = eng.state.pack([(s, 1) for s in decode], 1, pad_to=8)
            arrays = (rb.tokens[:, 0], rb.start_pos, rb.block_tables, rb.chunk_lens)
        elif key[0] == "verify":
            for s in decode:
                s.tokens.extend(rng.integers(0, vocab, SPEC_MAX_DRAFT).tolist())
            rb = eng.state.pack([(s, 1 + SPEC_MAX_DRAFT) for s in decode], key[2], pad_to=8)
            for s in decode:
                del s.tokens[-SPEC_MAX_DRAFT:]
            arrays = (rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens)
        else:
            work = [(s, 1) for s in decode] if key[1] == 1 else [(s, key[1]) for s in fresh]
            rb = eng.state.pack(work, key[1], pad_to=8)
            arrays = (rb.tokens, rb.start_pos, rb.block_tables, rb.chunk_lens)
        out[key] = tuple(np.ascontiguousarray(a) for a in arrays)
    return out


def graph_equals_eager(eng, key, arrays) -> dict:
    """The key's step run eagerly (``model.hidden`` + the LM head and
    argmax) and one replay of its graph, from the same arena: tokens and
    every arena byte must be identical."""
    fn, prog = eng._step_fn(key)[0], eng._step_fns[key]
    before = [t.clone() for t in eng.cache]
    eager = fn(*(torch.from_numpy(a).cuda() for a in arrays))
    eager_arena = [t.clone() for t in eng.cache]
    for t, s in zip(eng.cache, before):
        t.copy_(s)
    graph = prog.run(arrays)
    torch.cuda.synchronize()
    row = {"tokens_equal": torch.equal(eager, graph),
           "arena_equal": all(torch.equal(a, b) for a, b in zip(eager_arena, eng.cache)),
           "pages_written": int((eager_arena[0] != before[0]).flatten(1).any(1).sum()),
           "capture_s": prog.capture_s, "deltas": prog.counts.deltas}
    del before, eager_arena
    return row


def device_profile(fn) -> tuple:
    """``fn()`` once under torch.profiler: its device rows (kernels,
    memcpy/memset) as {name: (count, device us)}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def wall_ms(fn, reps: int = 5) -> float:
    """Median wall ms of ``fn()`` (ending in its readback)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def serve_greedy(eng, prompts, max_new) -> list:
    """Every prompt put at once, stepped until all are done; the streams."""
    uids = list(range(len(prompts)))
    for uid, (p, n) in enumerate(zip(prompts, max_new)):
        eng.put([uid], [p], max_new_tokens=n)
    for _ in range(2000):
        if all(eng.state.seqs[u].done for u in uids):
            break
        eng.step()
    else:
        raise AssertionError("serving made no progress in 2000 steps")
    streams = [list(eng.state.seqs[u].generated) for u in uids]
    for u in uids:
        eng.flush(u)
    return streams


def spec_vs_plain(spec_eng, plain_eng, prompts, max_new) -> dict:
    """The same greedy requests through a spec engine and a spec-less one;
    pages must all return after each."""
    res = {}
    streams = {}
    for name, eng in (("spec", spec_eng), ("plain", plain_eng)):
        pc = eng.kv.prefix_cache
        if pc is not None:
            pc.evict(pc.cached_pages)
        free0 = eng.kv.allocator.free_pages
        streams[name] = serve_greedy(eng, prompts, max_new)
        cached = pc.cached_pages if pc is not None else 0
        res[f"{name}_pages_accounted"] = eng.kv.allocator.free_pages + cached == free0
    st = spec_eng.spec_stats
    pairs = [(a, b) for s, p in zip(streams["spec"], streams["plain"]) for a, b in zip(s, p)]
    res.update(verify_rounds=st.rounds, proposed=st.proposed, accepted=st.accepted, emitted=st.emitted,
               acceptance_rate=st.acceptance_rate, rollback_pages=st.rollback_pages,
               tokens_equal_share=sum(a == b for a, b in pairs) / len(pairs),
               streams_equal=streams["spec"] == streams["plain"])
    return res, streams


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0**(math.floor(math.log2(abs(x))) - 7) if x else 2.0**-133


def first_difference_margins(cfg, state, prompts, streams) -> list:
    """Where the spec stream leaves the plain one: the position, the plain
    stream's top-2 logit margin there, and each stream's token's rank (the
    tokens with a strictly larger logit) and gap below the best logit, from
    the cache-free model (plain attention, the weights' dtype) on the prompt
    and the plain tokens before it (the same for both streams up to there)."""
    model = LlamaForCausalLM(dataclasses.replace(cfg, attention_impl="reference"), device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    out = []
    for i, (p, s, q) in enumerate(zip(prompts, streams["spec"], streams["plain"])):
        j = next((j for j, (a, b) in enumerate(zip(s, q)) if a != b), None)
        if j is None:
            continue
        ids = torch.tensor([p + q[:j]], dtype=torch.int64, device="cuda")
        with torch.no_grad():
            logits = model(ids)[0, -1].float()
        top = torch.topk(logits, 2).values
        margin = float(top[0] - top[1])
        out.append({"request": i, "position": j, "margin": margin, "top_logit": float(top[0]),
                    "tie": margin <= TIE_MARGIN * abs(float(top[0])), "spec_token": s[j], "plain_token": q[j],
                    "spec_rank": int((logits > logits[s[j]]).sum()), "plain_rank": int((logits > logits[q[j]]).sum()),
                    "spec_gap": float(top[0] - logits[s[j]]), "plain_gap": float(top[0] - logits[q[j]])})
    return out


def phase_step_graphs(cfg, state, smi: str) -> dict:
    """The step set as CUDA graphs and speculative decoding on Llama-3-8B
    (phase 3's width, depth and weights, bf16), then the float32 exactness
    of speculation at phase 4's setting."""
    layers = cfg.num_hidden_layers
    econf = dataclasses.replace(engine_config(torch.bfloat16, 1024), spec=SpecConfig(max_draft=SPEC_MAX_DRAFT))
    eng = build_engine(cfg, state, econf, device="cuda")
    reset_launch_counts()
    eng.forward_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = eng.warm_all()
    warm_s = time.perf_counter() - t0
    rewarm = eng.warm_all()
    pool = graph_pool_bytes(eng._graphs.pool)
    captures = {eng._key_label(k): eng._step_fns[k].capture_s for k in STEP_SET}
    log(f"  warm_all: {json.dumps(warm)} in {warm_s:.2f} s; again: {json.dumps(rewarm)}")
    log(f"  capture s by key (warm run included): {json.dumps(captures)}; graph pool {pool} B")
    checks = {"warm_all_captured_6": warm["compiled"] == len(warm["keys"]) == len(eng.step_shape_set()) == 6
              and warm["fallback"] == 0 and eng.step_shape_set() == STEP_SET,
              "rewarm_all_cached": rewarm["cached"] == 6 and rewarm["compiled"] == 0}

    prompts, max_new = serving_mix(cfg.vocab_size)
    batches = key_batches(eng, prompts, [64] * 8, np.random.default_rng(14))
    by_key = {eng._key_label(k): graph_equals_eager(eng, k, a) for k, a in batches.items()}
    log("  graph == eager by key: " + json.dumps(by_key))
    checks["graph_equals_eager_bit_for_bit"] = all(r["tokens_equal"] and r["arena_equal"] and r["pages_written"] > 0
                                                   for r in by_key.values())

    # K3 inside the graph: one replay of the fused rung of 8 rounds
    multi = ("multi", 8, 8)
    rows = device_profile(lambda: eng._step_fns[multi].run(batches[multi]))
    k3_events = sum(n for name, (n, _) in rows.items() if "paged_attention" in name)
    log(f"  profiled replay of {eng._key_label(multi)}: {k3_events} K3 kernel events, {len(rows)} device rows")
    checks["k3_runs_inside_the_graph"] = k3_events == layers * 8
    # and inside the verify graph: its capture recorded one forward of
    # `layers` K3 launches, and a profiled replay shows them on the device
    verify = STEP_SET[-1]
    vprog = eng._step_fns[verify]
    rows = device_profile(lambda: vprog.run(batches[verify]))
    k3_verify_events = sum(n for name, (n, _) in rows.items() if "paged_attention" in name)
    log(f"  profiled replay of {eng._key_label(verify)}: {k3_verify_events} K3 kernel events; "
        f"capture deltas {vprog.counts.deltas}")
    checks["k3_runs_inside_the_verify_graph"] = k3_verify_events == layers and vprog.counts.deltas[:2] == (1, layers)

    # the fused rung of 8 rounds on the same batch, eager (a Python loop of
    # forwards through model.hidden, as the engine dispatched it before the
    # step graphs) and as one replay; device busy share from one profiled
    # round of each over its unprofiled wall time
    arrays = batches[multi]

    def eager():
        eng._forward_multi(8, *(torch.from_numpy(a).cuda() for a in arrays)).cpu()

    def graph():
        eng._step_fns[multi].run(arrays).cpu()

    rounds = {}
    for name, fn in (("eager", eager), ("graph", graph), ("graph_again", graph), ("eager_again", eager)):
        fn()
        rounds[name] = wall_ms(fn) / 8
    for name, fn in (("eager", eager), ("graph", graph)):
        busy = sum(us for _, us in device_profile(fn).values()) / 1e3 / 8
        rounds[f"{name}_device_ms"] = busy
        rounds[f"{name}_busy_share"] = busy / min(rounds[name], rounds[f"{name}_again"])
    # one verify round (8 rows x 5 positions) the same two ways
    rounds["verify_eager"] = wall_ms(lambda: eng._forward_verify(
        *(torch.from_numpy(a).cuda() for a in batches[verify])).cpu())
    rounds["verify_graph"] = wall_ms(lambda: vprog.run(batches[verify]).cpu())
    log(f"  fused rung (per round) and verify round, wall ms ({smi}): " + json.dumps(rounds))
    for u in list(eng.state.seqs):
        eng.flush(u)

    # speculation: phase 3's greedy mix plus two pattern prompts, with and without
    plain_eng = build_engine(cfg, state, engine_config(torch.bfloat16, 1024), device="cuda")
    plain_eng.warm_all()
    mix = prompts + pattern_prompts(cfg.vocab_size)
    # the K3 launches of the serving run's verify rounds: what the verify
    # graph's replays added to the counter over that run
    launches0, rounds0 = vprog.counts.get(paged_attention_cuda), eng.spec_stats.rounds
    spec, streams = spec_vs_plain(eng, plain_eng, mix, max_new + [64, 64])
    verify_launches = vprog.counts.get(paged_attention_cuda) - launches0
    spec["verify_k3_launches"] = verify_launches
    # where a bf16 spec stream leaves the plain one, the spec token must be
    # within a few bf16 ulps of the best logit there
    diffs = first_difference_margins(cfg, state, mix, streams)
    spec["first_differences"] = [{"margin_share": d["margin"] / abs(d["top_logit"]),
                                  "spec_gap_ulps": d["spec_gap"] / bf16_ulp(d["top_logit"]),
                                  "plain_gap_ulps": d["plain_gap"] / bf16_ulp(d["top_logit"]),
                                  "spec_rank": d["spec_rank"], "plain_rank": d["plain_rank"]} for d in diffs]
    log("  speculation, bf16 (seeded random weights: the acceptance rate says nothing of a real model's): "
        + json.dumps(spec))
    checks["verify_rounds"] = spec["verify_rounds"] >= 1
    checks["verify_k3_launches_layers_x_rounds"] = verify_launches == layers * (eng.spec_stats.rounds - rounds0) > 0
    checks["bf16_differences_are_ties"] = all(d["spec_gap"] <= BF16_TIE_ULPS * bf16_ulp(d["top_logit"])
                                              for d in diffs)
    checks["pages_accounted_after_drain"] = spec["spec_pages_accounted"] and spec["plain_pages_accounted"]
    launches, forwards = paged_attention_cuda.launches, eng.forward_calls + plain_eng.forward_calls
    checks["k3_launches_layers_x_forwards"] = launches == layers * forwards and launches > 0
    del eng, plain_eng, batches
    gc.collect()
    torch.cuda.empty_cache()

    # float32 exactness at phase 4's setting
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32, state32 = llama3_8b(2, torch.float32, seed=1)
    rng = np.random.default_rng(2)
    prompts32 = [rng.integers(0, cfg32.vocab_size, n).tolist() for n in (40, 300, 700)] + \
        pattern_prompts(cfg32.vocab_size)
    econf32 = engine_config(torch.float32, 256)
    spec32_eng = build_engine(cfg32, state32, dataclasses.replace(econf32, spec=SpecConfig(max_draft=SPEC_MAX_DRAFT)),
                              device="cuda")
    f32, streams = spec_vs_plain(spec32_eng, build_engine(cfg32, state32, econf32, device="cuda"), prompts32,
                                 [64] * len(prompts32))
    f32["differences"] = first_difference_margins(cfg32, state32, prompts32, streams)
    f32["rounding_ties"] = sum(d["tie"] for d in f32["differences"])
    log("  speculation, float32 (2 layers): " + json.dumps(f32))
    checks["f32_spec_equals_plain_but_ties"] = f32["verify_rounds"] >= 1 and all(d["tie"] for d in f32["differences"])
    del spec32_eng, state32
    gc.collect()
    torch.cuda.empty_cache()

    res = {"card": smi, "warm_all": warm, "warm_all_s": warm_s, "capture_s": captures, "graph_pool_bytes": pool,
           "graph_vs_eager": by_key, "k3_events_in_replay": k3_events, "k3_events_in_verify_replay": k3_verify_events,
           "fused_round": rounds, "spec_bf16": spec, "spec_f32": f32, "k3_launches": launches,
           "verify_k3_launches": verify_launches, "forwards": forwards, "checks": checks}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"step-graph phase failed {bad}: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------- phase 14

FLEET_REPLICAS = 3
FLEET_PAGES = 512                  # 512 pages of 16 tokens: 1 GiB of bf16 KV a replica
FLEET_REQUESTS = 24
FLEET_RATE = 8.0                   # Poisson arrivals, requests/s
FLEET_PREFIX_GROUPS = 3
FLEET_PREFIX_PAGES = 32            # a 512-token shared prefix per group
FLEET_SUFFIX = 64                  # lognormal suffix tokens around this
FLEET_DEADLINE = (10.0, 0.5)       # deadline: arrival + 10 s + 0.5 s a new token
FLEET_KILL = 1.0                   # kill the last replica then ...
FLEET_RECOVER = 2.5                # ... and recover it, as bench_router.py's run_point does
# a replica holds at most 2 requests queued beyond its 8 running ones; the
# rest wait in the router's queue, so a recovered replica takes its share
FLEET_QUEUE_DEPTH = 2
FLEET_MEM_SLACK = 64 << 20


def fleet_workload(vocab: int, seed: int = 15) -> list:
    """``scripts/bench_router.py``'s ``_workload`` at Llama-3-8B's sizes:
    Poisson arrivals whose prompts share page-aligned group prefixes (512
    tokens) followed by a lognormal suffix, 32-64 new tokens each."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab, FLEET_PREFIX_PAGES * PAGE).tolist() for _ in range(FLEET_PREFIX_GROUPS)]
    t, out = 0.0, []
    for _ in range(FLEET_REQUESTS):
        t += float(rng.exponential(1.0 / FLEET_RATE))
        group = int(rng.integers(0, FLEET_PREFIX_GROUPS))
        suffix = int(np.clip(rng.lognormal(np.log(FLEET_SUFFIX), 0.4), 2, 4 * FLEET_SUFFIX))
        n_new = int(rng.integers(32, 65))
        out.append({"arrival_ts": round(t, 6), "prompt": prefixes[group] + rng.integers(1, vocab, suffix).tolist(),
                    "max_new_tokens": n_new,
                    "deadline": round(t + FLEET_DEADLINE[0] + FLEET_DEADLINE[1] * n_new, 6)})
    return out


def arena_bytes(eng) -> int:
    return sum(t.numel() * t.element_size() for t in eng.cache)


def graph_k3(eng) -> int:
    """K3 launches the engine's graph replays added (``ReplayCounts``)."""
    return sum(prog.counts.get(paged_attention_cuda) for prog in eng._step_fns.values()
               if hasattr(prog, "counts"))


def fleet_round_profile(router, pool, vocab: int) -> dict:
    """A fleet round in decode: 8 fresh requests a replica, stepped until
    every one decodes; then the wall time of one round (each replica's
    tick, ending in its readback) and the device time of the next round
    under torch.profiler, over that wall time (the profiler slows the
    host).  The fleet then drains."""
    from deepspeed_tpu_torch.serving.fleet import FleetSimulator
    rng = np.random.default_rng(16)
    n = 8 * len(pool.rids)
    for _ in range(n):
        router.submit(rng.integers(1, vocab, 64).tolist(), max_new_tokens=64, arrival_ts=pool.clock.now())
    router.dispatch_pending(pool.clock.now())

    def fleet_round():
        router.dispatch_pending(pool.clock.now())
        for rid in pool.rids:
            pool.tick(rid)
        router.poll(pool.clock.now())

    for _ in range(50):
        seqs = [s for rid in pool.rids for s in pool.replica(rid).serve.engine.state.seqs.values()]
        if router.queue_depth == 0 and all(pool.replica(rid).serve.load_stats()["queue_depth"] == 0
                                           for rid in pool.rids) and all(s.in_decode for s in seqs):
            break
        fleet_round()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet_round()
    wall = time.perf_counter() - t0
    rows = device_profile(fleet_round)
    busy_ms = sum(us for _, us in rows.values()) / 1e3
    FleetSimulator(router).run([])
    return {"round_ms": 1e3 * wall, "device_ms": busy_ms, "busy_share": busy_ms / (1e3 * wall),
            "k3_events": sum(c for name, (c, _) in rows.items() if "paged_attention" in name),
            "device_ops": sum(c for c, _ in rows.values())}


def fleet_failover_f32() -> dict:
    """``tests/unit/inference/test_fleet_router.py``'s
    ``test_kill_mid_decode_failover_outputs_identical`` on the card at
    phase 4's setting (float32, TF32 off, Llama-3-8B width, 2 layers, prefix
    cache on): two replicas on a ``VirtualClock``, round-robin, replica 0
    killed mid-decode at t = 4 and recovered at t = 10.  Every stream must
    equal a single engine's ``generate`` but for rounding ties (phase 13's
    rule), and a second run must give the same ``router.summary()``."""
    from deepspeed_tpu_torch.serving import VirtualClock
    from deepspeed_tpu_torch.serving.fleet import FleetSimulator, ReplicaPool, ReplicaState, RoundRobinPolicy, Router
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, state = llama3_8b(2, torch.float32, seed=1)
    econf = engine_config(torch.float32, 256)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 300, 700, 120)]
    golden = build_engine(cfg, state, econf, device="cuda").generate(prompts, max_new_tokens=48)
    runs = []
    for _ in range(2):
        pool = ReplicaPool(lambda: build_engine(cfg, state, econf, device="cuda"), 2, clock=VirtualClock())
        router = Router(pool, RoundRobinPolicy())
        at_kill = {}                 # fid -> tokens delivered when its replica died
        real_kill = pool.kill

        def kill(rid, reason="killed", router=router, real_kill=real_kill, at_kill=at_kill):
            at_kill.update({fr.fid: len(fr.tokens) for fr in router.requests
                            if fr._current is not None and fr._current[0] == rid})
            return real_kill(rid, reason)
        pool.kill = kill
        reqs = FleetSimulator(router).run(
            [dict(prompt=p, max_new_tokens=48, arrival_ts=0.5 * i) for i, p in enumerate(prompts)],
            schedule=[(4.0, "kill", 0), (10.0, "recover", 0)])
        victims = [r for r in reqs if r.failovers]
        runs.append({"tokens": [list(r.tokens) for r in reqs], "summary": router.summary(),
                     "done": all(r.state.name == "DONE" for r in reqs),
                     "mid_stream_victims": sum(1 for r in victims if 0 < at_kill.get(r.fid, 0) < r.max_new_tokens),
                     "victims": len(victims), "tokens_at_kill": at_kill,
                     "replica0": [h[2] for h in pool.health.history if h[0] == 0] == [
                         ReplicaState.DEAD, ReplicaState.RECOVERING, ReplicaState.HEALTHY]})
        del pool, router
    diffs = first_difference_margins(cfg, state, prompts, {"spec": runs[0]["tokens"], "plain": golden})
    res = {"streams_equal_generate": runs[0]["tokens"] == golden, "differences": diffs,
           "rounding_ties": sum(d["tie"] for d in diffs), "victims": runs[0]["victims"],
           "mid_stream_victims": runs[0]["mid_stream_victims"], "tokens_at_kill": runs[0]["tokens_at_kill"],
           "summaries_equal": runs[0]["summary"] == runs[1]["summary"],
           "tokens_equal_across_runs": runs[0]["tokens"] == runs[1]["tokens"],
           "failover": runs[0]["summary"]["failover"]}
    res["ok"] = (all(r["done"] and r["replica0"] for r in runs) and res["mid_stream_victims"] >= 1
                 and all(d["tie"] for d in diffs) and res["summaries_equal"] and res["tokens_equal_across_runs"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_fleet(cfg, state, smi: str) -> dict:
    """The serving fleet on Llama-3-8B: three replicas of one engine
    factory over phase 3's weights on one card, a ``PrefixDirectory`` and
    its routing policy, ``warm_all`` on each, then ``FleetSimulator`` on a
    wall clock over ``fleet_workload`` with the last replica killed at
    ``FLEET_KILL`` s and recovered at ``FLEET_RECOVER`` s (``scripts/
    bench_router.py``'s ``run_point``); then a profiled decode round, and
    the float32 failover scenario."""
    from deepspeed_tpu_torch.serving import ServingConfig
    from deepspeed_tpu_torch.serving.admission import AdmissionConfig
    from deepspeed_tpu_torch.serving.fleet import (FleetSimulator, PrefixDirectory, PrefixDirectoryPolicy,
                                                   ReplicaPool, ReplicaState, Router)
    layers = cfg.num_hidden_layers
    econf = engine_config(torch.bfloat16, FLEET_PAGES)
    made = []                       # every engine the factory built: a weak reference and its counts

    def factory():
        t0 = time.perf_counter()
        eng = build_engine(cfg, state, econf, device="cuda")
        made.append({"ref": weakref.ref(eng), "build_s": time.perf_counter() - t0, "forwards": None, "graph_k3": None})
        return eng

    weights = {t.data_ptr() for t in state.values()}
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    clock = WallClock()
    directory = PrefixDirectory(page_size=PAGE)
    pool = ReplicaPool(factory, FLEET_REPLICAS, clock=clock, prefix_directory=directory,
                       serving_config=ServingConfig(admission=AdmissionConfig(max_queue_depth=FLEET_QUEUE_DEPTH)))
    router = Router(pool, PrefixDirectoryPolicy(directory))
    engines = [pool.replica(rid).serve.engine for rid in pool.rids]
    shared = all({p.data_ptr() for p in e.model.parameters()} <= weights for e in engines)
    warm = []
    for e in engines:
        t0 = time.perf_counter()
        warm.append((e.warm_all()["compiled"], time.perf_counter() - t0))
    per_engine_mem = [arena_bytes(e) + graph_pool_bytes(e._graphs.pool) for e in engines]
    log(f"  {FLEET_REPLICAS} replicas built in {sum(m['build_s'] for m in made):.2f} s, weights shared: {shared}; "
        f"warm_all (keys, s): {warm}; arena {arena_bytes(engines[0])} B and graph pool "
        f"{graph_pool_bytes(engines[0]._graphs.pool)} B a replica; {torch.cuda.memory_allocated() - mem0} B "
        f"allocated beside the weights")
    del engines, e

    # instruments: tick errors, the kill (the dead engine's counts and the
    # memory around it), the recovery (build, warm_all, probe), round times
    errors, kill_info, rec_info, mem, tick_s = [], {}, {}, {}, []
    record_error = pool.health.record_error

    def on_error(rid, exc):
        errors.append((rid, repr(exc)))
        return record_error(rid, exc)
    pool.health.record_error = on_error
    real_kill, real_recover, real_warm, real_tick = pool.kill, pool.recover, pool._warm_replacement, pool.tick

    def kill(rid, reason="killed"):
        rep = pool.replica(rid)
        if rep.serve is not None:
            eng = rep.serve.engine
            rec = next(m for m in made if m["ref"]() is eng)
            rec.update(forwards=eng.forward_calls, graph_k3=graph_k3(eng), arena=arena_bytes(eng))
            kill_info.update(queued=len(rep.serve._queue), active=len(rep.serve._active),
                             in_flight_step=rep.serve._inflight is not None,
                             stream_idle=torch.cuda.current_stream().query())
            del eng, rec
        mem["before_kill"] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        victims = real_kill(rid, reason)
        kill_info["kill_s"] = time.perf_counter() - t0
        kill_info["dead_engine_collected"] = made[rid]["ref"]() is None
        mem["after_kill"] = torch.cuda.memory_allocated()
        return victims

    def recover(rid):
        rec_info["recover_call_ts"] = clock.now()
        t0 = time.perf_counter()
        n_made = len(made)
        real_recover(rid)
        rec_info["recover_s"] = time.perf_counter() - t0
        rec_info["build_s"] = sum(m["build_s"] for m in made[n_made:])
        eng = pool.replica(rid).serve.engine
        rec_info["fresh_arena"], rec_info["fresh_graph_pool"] = arena_bytes(eng), graph_pool_bytes(eng._graphs.pool)
        del eng
        mem["after_recovery"] = torch.cuda.memory_allocated()

    def warm_replacement(rid):
        t0 = time.perf_counter()
        real_warm(rid)
        rec_info["warm_all_s"] = time.perf_counter() - t0

    def tick(rid):
        t0 = time.perf_counter()
        out = real_tick(rid)
        tick_s.append((rid, time.perf_counter() - t0))
        return out
    real_warmup = router.warmup_replica

    def warmup_replica(rid):
        t0 = time.perf_counter()
        out = real_warmup(rid)
        rec_info["warmup_imports_s"] = time.perf_counter() - t0
        return out
    pool.kill, pool.recover, pool._warm_replacement, pool.tick = kill, recover, warm_replacement, tick
    router.warmup_replica = warmup_replica

    arrivals = fleet_workload(cfg.vocab_size)
    victim = FLEET_REPLICAS - 1
    schedule = [(FLEET_KILL, "kill", victim), (FLEET_RECOVER, "recover", victim)]
    for m in made:
        m["ref"]().forward_calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pool.rebase_clock()
    reset_launch_counts()
    t0 = time.perf_counter()
    sim = FleetSimulator(router)
    reqs = sim.run(arrivals, schedule=schedule)
    wall = time.perf_counter() - t0
    launches, split_calls = paged_attention_cuda.launches, paged_attention_cuda.split_calls
    peak = torch.cuda.max_memory_allocated()
    live = {rid: pool.replica(rid).serve.engine for rid in pool.rids}
    for m in made:
        eng = m["ref"]()
        if eng is not None:
            m.update(forwards=eng.forward_calls, graph_k3=graph_k3(eng))
    del eng
    forwards = sum(m["forwards"] for m in made)
    summary = router.summary()

    history = [(rid, a.name, b.name, ts, why) for rid, a, b, ts, why in pool.health.history]
    t_dead = next(ts for rid, _, b, ts, _ in history if rid == victim and b == "DEAD")
    t_recovering = next(ts for rid, _, b, ts, _ in history if rid == victim and b == "RECOVERING")
    t_healthy = next((ts for rid, _, b, ts, _ in history if rid == victim and b == "HEALTHY"), None)
    served_after = sum(1 for r in reqs if r.state.name == "DONE"
                       and any(rid == victim and ts >= (t_healthy or math.inf) for rid, ts in r.dispatches))
    pages = {rid: {"free": e.kv.allocator.free_pages, "cached": e.kv.prefix_cache.cached_pages,
                   "live": len(e.state.seqs)} for rid, e in live.items()}
    by_engine = [{"replica": i if i < FLEET_REPLICAS else victim, "forwards": m["forwards"],
                  "k3_launches": layers * m["forwards"], "graph_replay_k3": m["graph_k3"],
                  "build_s": m["build_s"]} for i, m in enumerate(made)]
    round_ticks = {}
    for rid, dt in tick_s:
        round_ticks.setdefault(rid, []).append(dt)
    res = {"card": smi, "replicas": FLEET_REPLICAS, "requests": len(reqs),
           "prompt_tokens": sum(len(a["prompt"]) for a in arrivals),
           "generated": sum(len(r.tokens) for r in reqs), "wall_s": wall, "rounds": sim.rounds,
           "round_wall_ms_mean": 1e3 * wall / sim.rounds,
           "tick_ms_p50_by_replica": {rid: 1e3 * float(np.median(v)) for rid, v in round_ticks.items()},
           "ttft_s": {k: summary["ttft"][k] for k in ("p50", "p99")},
           "tpot_s": {k: summary["tpot"][k] for k in ("p50", "p99")},
           "e2e_s_p50": summary["e2e"]["p50"], "goodput_rps": summary["goodput_rps"],
           "affinity": summary["affinity"], "prefix_imports": router.stats["prefix_imports"],
           "warmup_imports": router.stats["warmup_imports"], "failover": summary["failover"],
           # on the fleet's clock: the kill, the scheduled recover call
           # (the fresh engine's build and warm_all inside it), RECOVERING
           # (the directory's warm-up imports follow), HEALTHY after the
           # probe tick
           "recovery": {"dead_ts": t_dead, "recovering_ts": t_recovering, "healthy_ts": t_healthy,
                        "kill_to_healthy_s": None if t_healthy is None else t_healthy - t_dead, **rec_info,
                        "recovering_to_healthy_s": None if t_healthy is None else t_healthy - t_recovering},
           "kill": kill_info, "served_after_recovery": served_after, "history": history, "tick_errors": errors,
           "by_engine": by_engine, "k3_launches": launches, "k3_split_calls": split_calls, "forwards": forwards,
           "memory": {"weights": sum(t.numel() * t.element_size() for t in state.values()), **mem,
                      "peak": peak, "per_replica": per_engine_mem[0]}, "pages": pages}
    expected_history = [(victim, "HEALTHY", "DEAD"), (victim, "DEAD", "RECOVERING"), (victim, "RECOVERING", "HEALTHY")]
    fresh = rec_info.get("fresh_arena", 0) + rec_info.get("fresh_graph_pool", 0)
    checks = {
        "weights_shared": shared,
        "all_done_with_their_tokens": all(r.state.name == "DONE" and len(r.tokens) == a["max_new_tokens"]
                                          for r, a in zip(reqs, arrivals)),
        "one_kill_requeued": summary["failover"]["kills"] == 1 and summary["failover"]["requeued"] >= 1,
        "recovered_healthy_and_serving": t_healthy is not None and served_after >= 1,
        "no_tick_error": not errors,
        "only_scheduled_transitions": [h[:3] for h in history] == expected_history,
        "directory_routed_warm": summary["affinity"]["hits"] >= 1,
        "pages_accounted": all(p["live"] == 0 and p["free"] + p["cached"] == FLEET_PAGES - 1 for p in pages.values()),
        "k3_launches_layers_x_forwards_of_every_engine": launches == layers * forwards > 0
        and len(made) == FLEET_REPLICAS + 1 and all(m["forwards"] is not None for m in made),
        "dead_engine_collected": kill_info.get("dead_engine_collected", False),
        "kill_frees_the_arena": mem["after_kill"] <= mem["before_kill"] - made[victim]["arena"] + FLEET_MEM_SLACK,
        "recovery_memory_bounded": mem["after_recovery"] <= mem["before_kill"] + fresh + FLEET_MEM_SLACK,
    }
    pool.kill, pool.recover, pool._warm_replacement, pool.tick = real_kill, real_recover, real_warm, real_tick
    router.warmup_replica = real_warmup
    res["profiled_round"] = fleet_round_profile(router, pool, cfg.vocab_size)
    log(f"  fleet ({smi}): " + json.dumps(res))
    del live, pool, router, reqs, sim
    gc.collect()
    torch.cuda.empty_cache()
    res["f32_failover"] = fleet_failover_f32()
    log("  fleet failover, float32 (2 layers): " + json.dumps(res["f32_failover"]))
    checks["f32_failover_equals_generate_but_ties"] = res["f32_failover"]["ok"]
    res["checks"] = checks
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"fleet phase failed {bad}: {json.dumps(checks)}")
    return res


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- phases 16 and 17

# the published config.json of each checkpoint, in code (the weights are
# seeded, made under HF's names); phase 17 cuts each to ZOO_LAYERS layers
FALCON_7B = {"model_type": "falcon", "vocab_size": 65024, "hidden_size": 4544, "num_hidden_layers": 32,
             "num_attention_heads": 71, "multi_query": True, "parallel_attn": True, "new_decoder_architecture": False,
             "alibi": False, "bias": False, "layer_norm_epsilon": 1e-5, "tie_word_embeddings": True,
             "torch_dtype": "bfloat16"}                                                 # tiiuae/falcon-7b
ZOO = {
    "opt-6.7b": ({"model_type": "opt", "vocab_size": 50272, "hidden_size": 4096, "ffn_dim": 16384,
                  "num_hidden_layers": 32, "num_attention_heads": 32, "max_position_embeddings": 2048,
                  "do_layer_norm_before": True, "word_embed_proj_dim": 4096, "torch_dtype": "float16"}, "bin"),
    "phi-2": ({"model_type": "phi", "vocab_size": 51200, "hidden_size": 2560, "intermediate_size": 10240,
               "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
               "partial_rotary_factor": 0.4, "rope_theta": 10000.0, "layer_norm_eps": 1e-5,
               "max_position_embeddings": 2048, "tie_word_embeddings": False, "qk_layernorm": False,
               "torch_dtype": "float16"}, "safetensors"),
    "phi-3-mini-4k": ({"model_type": "phi3", "vocab_size": 32064, "hidden_size": 3072, "intermediate_size": 8192,
                       "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
                       "max_position_embeddings": 4096, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
                       "sliding_window": 2047, "tie_word_embeddings": False, "torch_dtype": "bfloat16"},
                      "safetensors"),
    "mistral-7b-v0.1": ({"model_type": "mistral", "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
                         "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
                         "max_position_embeddings": 32768, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
                         "sliding_window": 4096, "tie_word_embeddings": False, "torch_dtype": "bfloat16"},
                        "safetensors"),
    "qwen2-7b": ({"model_type": "qwen2", "vocab_size": 152064, "hidden_size": 3584, "intermediate_size": 18944,
                  "num_hidden_layers": 28, "num_attention_heads": 28, "num_key_value_heads": 4,
                  "max_position_embeddings": 131072, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
                  "sliding_window": 131072, "use_sliding_window": False, "max_window_layers": 28,
                  "tie_word_embeddings": False, "torch_dtype": "bfloat16"}, "safetensors"),
    "falcon-rw-1b": ({"model_type": "falcon", "vocab_size": 50304, "hidden_size": 2048, "num_hidden_layers": 24,
                      "num_attention_heads": 32, "multi_query": False, "parallel_attn": False,
                      "new_decoder_architecture": False, "alibi": True, "bias": True, "layer_norm_epsilon": 1e-5,
                      "tie_word_embeddings": True, "torch_dtype": "bfloat16"}, "safetensors"),
}
ZOO_LAYERS = 2
# Mistral's long request: 4608 tokens, so its window of 4096 bites in prefill and decode
MISTRAL_LONG = 4608
ZOO_MAX_PAGES = 320                # 5120 keys a sequence: the long request and its new tokens
SAFETENSORS_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.int64: "I64",
                     torch.int32: "I32", torch.bool: "BOOL"}


def hf_shapes(hf: dict) -> dict:
    """The HF state dict's tensor names and shapes of a config (the names
    ``save_pretrained`` writes; tied heads left out)."""
    t, e, layers, v = hf["model_type"], hf["hidden_size"], hf["num_hidden_layers"], hf["vocab_size"]
    h = hf["num_attention_heads"]
    d = e // h
    out = {}
    if t == "falcon":
        kv = 1 if hf["multi_query"] else h
        rows = (h + 2 * kv) * d if kv == 1 else 3 * h * d
        out["transformer.word_embeddings.weight"] = (v, e)
        for i in range(layers):
            p = f"transformer.h.{i}"
            lns = ("input_layernorm", ) + (() if hf["parallel_attn"] else ("post_attention_layernorm", ))
            for ln in lns:
                out[f"{p}.{ln}.weight"] = out[f"{p}.{ln}.bias"] = (e, )
            mats = {"self_attention.query_key_value": (rows, e), "self_attention.dense": (e, e),
                    "mlp.dense_h_to_4h": (4 * e, e), "mlp.dense_4h_to_h": (e, 4 * e)}
            for name, shape in mats.items():
                out[f"{p}.{name}.weight"] = shape
                if hf["bias"]:
                    out[f"{p}.{name}.bias"] = (shape[0], )
        out["transformer.ln_f.weight"] = out["transformer.ln_f.bias"] = (e, )
    elif t == "opt":
        f = hf["ffn_dim"]
        out["model.decoder.embed_tokens.weight"] = (v, e)
        out["model.decoder.embed_positions.weight"] = (hf["max_position_embeddings"] + 2, e)
        for i in range(layers):
            p = f"model.decoder.layers.{i}"
            mats = {"self_attn.q_proj": (e, e), "self_attn.k_proj": (e, e), "self_attn.v_proj": (e, e),
                    "self_attn.out_proj": (e, e), "fc1": (f, e), "fc2": (e, f)}
            for name, shape in mats.items():
                out[f"{p}.{name}.weight"], out[f"{p}.{name}.bias"] = shape, (shape[0], )
            for ln in ("self_attn_layer_norm", "final_layer_norm"):
                out[f"{p}.{ln}.weight"] = out[f"{p}.{ln}.bias"] = (e, )
        out["model.decoder.final_layer_norm.weight"] = out["model.decoder.final_layer_norm.bias"] = (e, )
    elif t == "phi":
        f = hf["intermediate_size"]
        out["model.embed_tokens.weight"] = (v, e)
        for i in range(layers):
            p = f"model.layers.{i}"
            mats = {"self_attn.q_proj": (e, e), "self_attn.k_proj": (e, e), "self_attn.v_proj": (e, e),
                    "self_attn.dense": (e, e), "mlp.fc1": (f, e), "mlp.fc2": (e, f)}
            for name, shape in mats.items():
                out[f"{p}.{name}.weight"], out[f"{p}.{name}.bias"] = shape, (shape[0], )
            out[f"{p}.input_layernorm.weight"] = out[f"{p}.input_layernorm.bias"] = (e, )
        out["model.final_layernorm.weight"] = out["model.final_layernorm.bias"] = (e, )
        out["lm_head.weight"], out["lm_head.bias"] = (v, e), (v, )
    else:   # the Llama layout: mistral, qwen2 (q/k/v biases), phi3 (fused qkv and gate_up), mixtral and
        # qwen2_moe (expert banks; Qwen2-MoE with q/k/v biases)
        kv, f = hf["num_key_value_heads"], hf["intermediate_size"]
        out["model.embed_tokens.weight"] = (v, e)
        for i in range(layers):
            p = f"model.layers.{i}"
            if t == "phi3":
                mats = {"self_attn.qkv_proj": ((h + 2 * kv) * d, e), "mlp.gate_up_proj": (2 * f, e),
                        "mlp.down_proj": (e, f)}
            else:
                mats = {"self_attn.q_proj": (h * d, e), "self_attn.k_proj": (kv * d, e),
                        "self_attn.v_proj": (kv * d, e)}
                mats.update(moe_mlp_shapes(hf, i) if t in ("mixtral", "qwen2_moe") else
                            {"mlp.gate_proj": (f, e), "mlp.up_proj": (f, e), "mlp.down_proj": (e, f)})
            mats["self_attn.o_proj"] = (e, h * d)
            for name, shape in mats.items():
                out[f"{p}.{name}.weight"] = shape
                if t in ("qwen2", "qwen2_moe") and name in ("self_attn.q_proj", "self_attn.k_proj",
                                                             "self_attn.v_proj"):
                    out[f"{p}.{name}.bias"] = (shape[0], )
            out[f"{p}.input_layernorm.weight"] = out[f"{p}.post_attention_layernorm.weight"] = (e, )
        out["model.norm.weight"] = (e, )
        out["lm_head.weight"] = (v, e)
    return out


def moe_mlp_shapes(hf: dict, i: int) -> dict:
    """Layer ``i``'s MLP under HF's names: Mixtral's ``block_sparse_moe``
    (router and experts w1/w3/w2), Qwen2-MoE's sparse ``mlp`` (router,
    experts, shared expert and its gate) or, in a mixed stack, dense ``mlp``."""
    e = hf["hidden_size"]
    if hf["model_type"] == "mixtral":
        f, n = hf["intermediate_size"], hf["num_local_experts"]
        out = {"block_sparse_moe.gate": (n, e)}
        for x in range(n):
            q = f"block_sparse_moe.experts.{x}"
            out.update({f"{q}.w1": (f, e), f"{q}.w3": (f, e), f"{q}.w2": (e, f)})
        return out
    if i in hf.get("mlp_only_layers", []) or (i + 1) % hf.get("decoder_sparse_step", 1):
        f = hf["intermediate_size"]
        return {"mlp.gate_proj": (f, e), "mlp.up_proj": (f, e), "mlp.down_proj": (e, f)}
    m, si, n = hf["moe_intermediate_size"], hf["shared_expert_intermediate_size"], hf["num_experts"]
    out = {"mlp.gate": (n, e), "mlp.shared_expert_gate": (1, e), "mlp.shared_expert.gate_proj": (si, e),
           "mlp.shared_expert.up_proj": (si, e), "mlp.shared_expert.down_proj": (e, si)}
    for x in range(n):
        out.update({f"mlp.experts.{x}.gate_proj": (m, e), f"mlp.experts.{x}.up_proj": (m, e),
                    f"mlp.experts.{x}.down_proj": (e, m)})
    return out


def seeded_hf_tensor(name: str, shape, dtype, gen: torch.Generator) -> torch.Tensor:
    """One seeded tensor under its HF name, drawn from ``gen`` on its device:
    norm scales 1, norm biases 0, other biases N(0, 0.02²), embeddings
    N(0, 0.02²), matrices N(0, 1/fan_in)."""
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    if re.search(r"(norm|ln_f|ln_attn|ln_mlp)\.", name) is not None:
        t.fill_(1.0 if name.endswith("weight") else 0.0)
    elif name.endswith("bias") or "embed" in name:
        t.normal_(0.0, 0.02, generator=gen)
    else:
        t.normal_(0.0, shape[1]**-0.5, generator=gen)
    return t


def seeded_hf_state(shapes: dict, dtype, seed: int) -> dict:
    """Seeded weights on the card under HF's names (``seeded_hf_tensor``,
    one generator in the order of ``shapes``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {name: seeded_hf_tensor(name, shape, dtype, gen) for name, shape in shapes.items()}


def qwen_port_name(hf_name: str) -> tuple:
    """The port's name of a Qwen2-MoE HF tensor (``Qwen2MoePolicy``'s
    mapping), and the expert of a bank it is one row of (None otherwise)."""
    m = re.fullmatch(r"model\.layers\.(\d+)\.mlp\.experts\.(\d+)\.(gate|up|down)_proj\.weight", hf_name)
    if m:
        return f"layers.{m[1]}.mlp.w_{m[3]}", int(m[2])
    name = hf_name.replace(".mlp.shared_expert.", ".mlp.shared_")
    return (name[len("model."):] if name.startswith("model.") else name), None


def qwen_rank_state(hf: dict, dtype, seed: int, tp) -> tuple:
    """Tensor-parallel rank ``tp.rank``'s slices of the seeded Qwen2-MoE of
    ``hf`` (``seeded_hf_state(hf_shapes(hf), dtype, seed)`` through
    ``Qwen2MoePolicy``, as phase 18 serves it): each HF tensor drawn whole
    from the same generator in the same order and cut to the rank's slice
    at once (an expert's matrix transposed into its row of the bank), so a
    rank never holds the whole model.  Returns (config, state dict)."""
    from deepspeed_tpu_torch.module_inject.layers import narrow_to_rank, tp_dims
    cfg = dataclasses.replace(Qwen2MoePolicy().build_config(hf), dtype=dtype, param_dtype=dtype)
    model = build_cache_model(cfg, PAGE, device="meta", tensor_parallel=tp.size)
    cut = tp_dims(model)
    state = {k: torch.empty(v.shape, dtype=dtype, device="cuda") for k, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, shape in hf_shapes(hf).items():
        whole = seeded_hf_tensor(name, shape, dtype, gen)
        port, expert = qwen_port_name(name)
        if expert is None:
            state[port].copy_(narrow_to_rank(whole, cut.get(port), tp))
        else:
            state[port][expert].copy_(narrow_to_rank(whole.T, cut[port] - 1, tp))
        del whole
    return cfg, state


def write_safetensors(filename: str, tensors: dict) -> None:
    """A ``.safetensors`` file: the 8-byte little-endian header length, the
    JSON header (padded with spaces to 8 bytes), then every tensor's bytes."""
    import struct
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(filename, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())


def write_checkpoint(path: str, hf: dict, state: dict, fmt: str) -> int:
    """``config.json`` and the weights (``model.safetensors`` or
    ``pytorch_model.bin``) in ``path``; returns the weights' bytes."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    if fmt == "safetensors":
        filename = os.path.join(path, "model.safetensors")
        write_safetensors(filename, state)
    else:
        filename = os.path.join(path, "pytorch_model.bin")
        torch.save({k: v.cpu() for k, v in state.items()}, filename)
    return os.path.getsize(filename)


def greedy_ties(eng_a, eng_b, prompts, streams_a, streams_b) -> list:
    """Where stream b leaves stream a (prompts within one prefill chunk): the
    position, and whether it is a bf16 rounding tie — the two tokens are each
    other's runner-up on both paths' logits of the context before it, within
    BF16_TIE_ULPS ulps of the best."""
    out = []
    for i, (p, a, b) in enumerate(zip(prompts, streams_a, streams_b)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        tie = True
        for eng in (eng_a, eng_b):
            eng.kv.prefix_cache.evict(eng.kv.prefix_cache.cached_pages)   # the context prefills whole
            logits = first_step_logits(eng, p + a[:j])
            top = float(logits.max())
            near = set(torch.nonzero(logits >= top - BF16_TIE_ULPS * bf16_ulp(top)).flatten().tolist())
            tie = tie and {a[j], b[j]} <= near
        out.append({"request": i, "position": j, "tokens": [a[j], b[j]], "tie": tie})
    return out


def greedy_parity_bf16(cfg, state) -> dict:
    """A short bf16 greedy run, kernel path against plain path: streams equal
    but for rounding ties (``greedy_ties``)."""
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 120, 200)]
    engines, streams = {}, {}
    for impl in ("flash", "reference"):
        engines[impl] = build_engine(dataclasses.replace(cfg, attention_impl=impl), state,
                                     engine_config(cfg.dtype, 128), device="cuda")
        streams[impl] = serve_greedy(engines[impl], prompts, [8] * len(prompts))
    ties = greedy_ties(engines["reference"], engines["flash"], prompts, streams["reference"], streams["flash"])
    res = {"streams_equal": streams["flash"] == streams["reference"], "first_differences": ties}
    log(f"  bf16 greedy parity (kernel vs plain, {len(prompts)} x 8 tokens): {json.dumps(res)}")
    if not all(t["tie"] for t in ties):
        raise AssertionError(f"bf16 greedy streams differ beyond a rounding tie: {ties}")
    return res


def phase_falcon_7b(smi: str) -> dict:
    """Falcon-7B at full width and depth: seeded bf16 weights made on the
    card under HF's names, through ``FalconPolicy.convert`` in memory (no
    disk); phase 3's serving mix, profile and bf16 parity."""
    policy = FalconPolicy()
    cfg = dataclasses.replace(policy.build_config(FALCON_7B), dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    state = policy.convert(seeded_hf_state(hf_shapes(FALCON_7B), torch.bfloat16, seed=16), cfg)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    log(f"  Falcon-7B weights: {nbytes / 1e9:.2f} GB bf16, made and converted in {time.perf_counter() - t0:.2f} s")
    serving = phase_serving(cfg, state, smi)
    profile = phase_profile(cfg, state)
    parity = phase_parity_bf16(cfg, state)
    greedy = greedy_parity_bf16(cfg, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"serving": serving, "profile": profile, "parity": parity, "greedy": greedy, "weight_bytes": nbytes}


def zoo_mix(name: str, vocab: int) -> tuple:
    """Phase 3's mix; Mistral's adds one request of MISTRAL_LONG tokens."""
    prompts, max_new = serving_mix(vocab)
    if name.startswith("mistral"):
        prompts.append(np.random.default_rng(17).integers(0, vocab, MISTRAL_LONG).tolist())
        max_new.append(32)
    return prompts, max_new


def zoo_f32_prompts(name: str, vocab: int) -> list:
    """The float32 greedy prompts of a zoo model (Mistral's one longer than its window)."""
    rng = np.random.default_rng(18)
    lens = (40, 300, 700) + ((4400, ) if name.startswith("mistral") else ())
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def zoo_parity_f32(name: str, eng) -> dict:
    """The model's weights in float32 through the kernel path and the plain
    path: identical greedy streams (TF32 off), the window biting for
    Mistral."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(eng.cfg, dtype=torch.float32, param_dtype=torch.float32)
    state = {k: v.float() for k, v in eng.model.state_dict().items()}
    prompts = zoo_f32_prompts(name, cfg.vocab_size)
    lens = [len(p) for p in prompts]
    streams = {}
    for impl in ("flash", "reference"):
        e = build_engine(dataclasses.replace(cfg, attention_impl=impl), state,
                         engine_config(torch.float32, 512, ZOO_MAX_PAGES), device="cuda")
        streams[impl] = serve_greedy(e, prompts, [12] * len(prompts))
        del e
    if streams["flash"] != streams["reference"]:
        raise AssertionError(f"{name}: f32 greedy streams differ between the kernel and the plain path: {streams}")
    return {"f32_streams_identical": True, "prompt_lens": lens, "f32_streams": streams["flash"]}


def serve_checkpoint_dir(root: str, name: str, published: dict, layers: int, fmt: str, seed: int, smi: str,
                         keep: bool = False) -> dict:
    """A checkpoint at its published widths, cut to ``layers`` layers, written
    to a directory under ``root`` and served through ``build_hf_engine``:
    phase 3's mix (tokens, pages, K3 == layers x forwards, its steps
    captured as CUDA graphs), then the float32 kernel path against the plain
    path; the directory is removed after, or with ``keep`` kept for phase
    27(a) with its one-card reference (``tp_reference``)."""
    hf = dict(published, num_hidden_layers=layers)
    path = os.path.join(root, name)
    t0 = time.perf_counter()
    state = seeded_hf_state(hf_shapes(hf), torch.bfloat16, seed=seed)
    nbytes = write_checkpoint(path, hf, state, fmt)
    del state
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = build_hf_engine(path, engine_config(torch.bfloat16, 1024, ZOO_MAX_PAGES), device="cuda")
    t_load = time.perf_counter() - t0
    log(f"  {name} ({layers} of {published['num_hidden_layers']} layers): {fmt} {nbytes / 1e9:.2f} GB, "
        f"written in {t_write:.2f} s, build_hf_engine {t_load:.2f} s")
    res = serve_mix(eng, *zoo_mix(name, eng.cfg.vocab_size), smi)
    graphs = sum(hasattr(prog, "graph") for prog in eng._step_fns.values())
    if graphs == 0:
        raise AssertionError(f"{name}: no step of the mix ran as a captured CUDA graph")
    log(f"  {name}: the mix's {graphs} step programs ran as captured CUDA graphs")
    if keep:
        res["tp_reference"] = tp_reference(eng, eng.model.state_dict())
    res.update(zoo_parity_f32(name, eng), step_graphs=graphs, format=fmt, weight_bytes=nbytes, write_s=t_write,
               load_s=t_load,
               window=getattr(eng.cfg, "sliding_window", 0), alibi=getattr(eng.cfg, "alibi", False),
               head_dim=eng.cfg.hidden_size // eng.cfg.num_attention_heads)
    if keep:
        res["tp_reference"]["f32_streams"] = res.pop("f32_streams")
        res["dir"] = path
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if not keep:
        shutil.rmtree(path)
    return res


def phase_zoo(smi: str, keep_root=None) -> dict:
    """Each zoo checkpoint written to a directory at its published widths,
    cut to ZOO_LAYERS layers, and served through ``build_hf_engine``: phase
    3's mix (tokens, pages, K3 == layers x forwards), then the float32
    kernel path against the plain path; the directory is removed after,
    but TP_ZOO's, kept under ``keep_root`` (if given) for phase 27(a)."""
    root = tempfile.mkdtemp(prefix="zoo_")
    out = {}
    try:
        for i, (name, (published, fmt)) in enumerate(ZOO.items()):
            keep = keep_root is not None and name in TP_ZOO
            out[name] = serve_checkpoint_dir(keep_root if keep else root, name, published, ZOO_LAYERS, fmt,
                                             170 + i, smi, keep=keep)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not any(r["format"] == "safetensors" for r in out.values()):
        raise AssertionError("no zoo checkpoint loaded from safetensors")
    return out


# ---------------------------------------------------------------- phases 18-20

# the published config.json of each MoE checkpoint, in code (seeded weights)
QWEN_MOE = {"model_type": "qwen2_moe", "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 5632,
            "moe_intermediate_size": 1408, "shared_expert_intermediate_size": 5632, "num_hidden_layers": 24,
            "num_attention_heads": 16, "num_key_value_heads": 16, "num_experts": 60, "num_experts_per_tok": 4,
            "norm_topk_prob": False, "decoder_sparse_step": 1, "mlp_only_layers": [],
            "max_position_embeddings": 8192, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
            "tie_word_embeddings": False, "torch_dtype": "bfloat16"}                   # Qwen/Qwen1.5-MoE-A2.7B
MIXTRAL_8X7B = {"model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
                "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
                "max_position_embeddings": 32768, "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
                "num_local_experts": 8, "num_experts_per_tok": 2, "router_aux_loss_coef": 0.02,
                "sliding_window": None, "tie_word_embeddings": False,
                "torch_dtype": "bfloat16"}                                              # mistralai/Mixtral-8x7B-v0.1
# phase 19's cut: one Mixtral layer is 2.9 GB of bf16, the 32 (93 GB) do not fit one card
MIXTRAL_LAYERS = 2
# phase 20: Mixtral-8x7B's widths at one layer, B 2 of S 1024, bf16
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S = 1, 2, 1024
MOE_TRAIN_WARMUP, MOE_TRAIN_TIMED = 2, 3
MOE_DS_CONFIG = {"train_batch_size": MOE_TRAIN_B, "optimizer": {"type": "AdamW",
                                                                "params": {"lr": 1e-4, "weight_decay": 0.01}},
                 "bf16": {"enabled": True}, "moe": {"enabled": True, "expert_parallel_size": 1},
                 "steps_per_print": 0}
ROUTER_SUFFIXES = ("mlp.gate", "block_sparse_moe.gate")


def routed_first_step(eng, prompt) -> tuple:
    """``first_step_logits`` with every router's float32 logits of the
    prompt's tokens and its input, recorded by forward hooks on the eager
    forward: (logits, [L, n, E], [L, n, d])."""
    outs, ins = [], []

    def record(mod, args, out):
        outs.append(out.detach().clone())
        ins.append(args[0].detach().float().clone())

    hooks = [m.register_forward_hook(record) for name, m in eng.model.named_modules() if name.endswith(ROUTER_SUFFIXES)]
    try:
        logits = first_step_logits(eng, prompt)
    finally:
        for h in hooks:
            h.remove()
    chunk = eng.econfig.scheduler.prefill_chunk
    return logits, *(torch.stack([r.view(-1, chunk, r.shape[-1])[0, :len(prompt)] for r in rec]) for rec in (outs, ins))


def expert_histogram(routers: torch.Tensor, k: int) -> list:
    """Per layer, the top-k choices each expert took."""
    idx = torch.topk(routers, k, dim=-1).indices
    return [torch.bincount(i.flatten(), minlength=routers.shape[-1]).tolist() for i in idx]


def routing_flips(ra: torch.Tensor, rb: torch.Tensor, k: int, xa=None, xb=None) -> list:
    """Each (layer, token) whose top-k expert set differs between two paths'
    router logits ([L, n, E]), in layer order: the experts each chose, each
    path's margin at its top-k boundary (its k-th largest logit minus its
    (k+1)-th) beside BF16_TIE_ULPS bf16 ulps of the token's largest |logit|
    (a logit is a sum of products of that order, so its rounding is too),
    and the layer of the token's first flip.  A token's first flip must be a
    rounding tie: both margins within.  A flip moves that token's hidden
    state by much more than rounding (another expert's output), so its later
    flips may have larger margins.  Given the
    routers' inputs ([L, n, d]), each flip also carries its token's relative
    input difference between the paths (``input_diff``) beside the largest
    one among the tokens that had not flipped before that layer
    (``unflipped_max``): the measure of how far the earlier flip moved it."""
    out, first = [], {}
    for layer, (a, b) in enumerate(zip(ra.float(), rb.float())):
        sa, ia = torch.sort(a, dim=-1, descending=True, stable=True)
        sb, ib = torch.sort(b, dim=-1, descending=True, stable=True)
        differ = (ia[:, :k].sort(-1).values != ib[:, :k].sort(-1).values).any(-1)
        diff = None
        if xa is not None:
            diff = ((xa[layer] - xb[layer]).norm(dim=-1) / xb[layer].norm(dim=-1)).tolist()
            clean = [d for t, d in enumerate(diff) if t not in first]
        for t in torch.nonzero(differ).flatten().tolist():
            margins = [float(s[t, k - 1] - s[t, k]) for s in (sa, sb)]
            limits = [BF16_TIE_ULPS * bf16_ulp(float(s[t].abs().max())) for s in (sa, sb)]
            first.setdefault(t, layer)
            flip = {"layer": layer, "token": t, "experts": [ia[t, :k].tolist(), ib[t, :k].tolist()],
                    "margins": margins, "limits": limits, "first_flip_layer": first[t],
                    "tie": all(m <= lim for m, lim in zip(margins, limits))}
            if diff is not None:
                flip.update(input_diff=diff[t], unflipped_max=max(clean, default=0.0))
            out.append(flip)
    return out


def moe_parity_bf16(cfg, state) -> dict:
    """Phase 4's bf16 logits parity on an MoE model, with its routing flips:
    the bf16 kernel path and the bf16 plain path, each held against the
    plain path in float32 on the same (upcast) weights, within phase 4's
    bounds; each token whose top-k set differs between the two bf16 paths is
    reported (``routing_flips``): each token's first flip must be a
    rounding tie, and each later flip beyond one must carry a router input
    moved further between the paths than any not yet flipped token's at
    that layer (its earlier flip moved it).  The float32
    weights replace ``state``'s bf16 tensors one by one (both copies of
    Qwen1.5-MoE, 86 GB, do not fit the card): ``state`` holds float32
    after, and no engine may hold its bf16 tensors."""
    k = cfg.num_experts_per_tok
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 200).tolist()
    logits, routers, inputs = {}, {}, {}
    for impl in ("flash", "reference"):
        eng = build_engine(dataclasses.replace(cfg, attention_impl=impl), state, engine_config(cfg.dtype, 64),
                           device="cuda")
        logits[impl], routers[impl], inputs[impl] = routed_first_step(eng, prompt)
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    for name in list(state):
        state[name] = state[name].float()
    f32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32, attention_impl="reference")
    eng = build_engine(f32, state, engine_config(torch.float32, 64), device="cuda")
    logits["f32"], routers["f32"], _ = routed_first_step(eng, prompt)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    def rel(a, b):
        return float((logits[a] - logits[b]).norm() / logits[b].norm())

    flips = routing_flips(routers["flash"], routers["reference"], k, inputs["flash"], inputs["reference"])
    firsts = [f for f in flips if f["first_flip_layer"] == f["layer"]]
    laters = [f for f in flips if f["first_flip_layer"] < f["layer"]]
    hist = expert_histogram(routers["flash"], k)
    res = {"kernel_vs_plain": rel("flash", "reference"), "kernel_vs_f32": rel("flash", "f32"),
           "plain_vs_f32": rel("reference", "f32"),
           "max_abs_kernel_vs_plain": float((logits["flash"] - logits["reference"]).abs().max()),
           "argmax_equal": bool(logits["flash"].argmax() == logits["reference"].argmax()),
           "router_decisions": len(hist) * len(prompt), "routing_flips": len(flips), "first_flips": len(firsts),
           "first_flips_not_ties": [f for f in firsts if not f["tie"]],
           "max_first_flip_margin_ulps": max((max(m / lim * BF16_TIE_ULPS for m, lim in zip(f["margins"], f["limits"]))
                                              for f in firsts), default=0.0),
           "later_flips": len(laters), "later_flips_beyond_ties": sum(not f["tie"] for f in laters),
           "later_flips_unexplained": [f for f in laters if not f["tie"] and f["input_diff"] <= f["unflipped_max"]],
           "routing_flips_vs_f32": len(routing_flips(routers["flash"], routers["f32"], k)), "flips": flips[:8]}
    log(f"  bf16 parity ({cfg.num_hidden_layers} layers, relative L2 of logits; routing flips kernel vs plain): "
        + json.dumps(res))
    log(f"  later flips: {len(laters)}, of which {sum(f['input_diff'] > f['unflipped_max'] for f in laters)} with "
        f"the token's router input moved further than any not yet flipped token's; those beyond ties:")
    for f in laters:
        if f["tie"]:
            continue
        ulps = [round(m / lim * BF16_TIE_ULPS, 2) for m, lim in zip(f["margins"], f["limits"])]
        log(f"  later flip: layer {f['layer']} token {f['token']} (first flip at layer {f['first_flip_layer']}): "
            f"margins {ulps} ulps; input differs by {f['input_diff']:.4g} "
            f"(tokens not yet flipped: at most {f['unflipped_max']:.4g})")
    used = [sum(c > 0 for c in h) for h in hist]
    log(f"  experts chosen by the {len(prompt)} prompt tokens (top-{k}), per layer: used "
        f"{min(used)}-{max(used)} of {len(hist[0])}, the busiest took {max(max(h) for h in hist)} of "
        f"{k * len(prompt)}; layer 0: {hist[0]}; layer {len(hist) - 1}: {hist[-1]}")
    e = res["plain_vs_f32"]
    if not (np.isfinite(res["kernel_vs_plain"]) and res["kernel_vs_plain"] <= 2 * e
            and res["kernel_vs_f32"] <= 1.5 * e):
        raise AssertionError(f"bf16 kernel path out of tolerance: {res}")
    if res["first_flips_not_ties"]:
        raise AssertionError(f"a token's first routing flip beyond bf16 rounding between the kernel and plain paths: "
                             f"{res['first_flips_not_ties']}")
    if res["later_flips_unexplained"]:
        raise AssertionError(f"a later routing flip beyond bf16 rounding whose router input moved no further than "
                             f"a not yet flipped token's: {res['later_flips_unexplained']}")
    res["experts_used_per_layer"] = used
    return res


def phase_qwen_moe(smi: str) -> dict:
    """Qwen1.5-MoE-A2.7B at full width and depth: seeded bf16 weights made on
    the card under HF's names, through ``Qwen2MoePolicy.convert`` in memory;
    phase 3's mix and checks (K3 == 24 x forwards), a profiled decode
    round, the bf16 greedy streams of the kernel and plain paths equal but
    for rounding ties, then phase 4's logits parity with the routing flips
    and the expert histogram."""
    policy = Qwen2MoePolicy()
    cfg = dataclasses.replace(policy.build_config(QWEN_MOE), dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    state = policy.convert(seeded_hf_state(hf_shapes(QWEN_MOE), torch.bfloat16, seed=18), cfg)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    n_params = sum(t.numel() for t in state.values())
    log(f"  Qwen1.5-MoE-A2.7B weights: {n_params / 1e9:.2f} B parameters, {nbytes / 1e9:.2f} GB bf16, made and "
        f"converted in {time.perf_counter() - t0:.2f} s")
    serving = phase_serving(cfg, state, smi)
    gc.collect()
    profile = phase_profile(cfg, state)
    gc.collect()
    greedy = greedy_parity_bf16(cfg, state)
    gc.collect()
    parity = moe_parity_bf16(cfg, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"serving": serving, "profile": profile, "greedy": greedy, "parity": parity, "weight_bytes": nbytes,
            "params": n_params, "tp_f32_reference": qwen_f32_reference()}


def qwen_f32_hf() -> dict:
    """Phase 27(a)'s float32 Qwen1.5-MoE: the published widths at TP_QWEN_F32_LAYERS layers."""
    return {**QWEN_MOE, "num_hidden_layers": TP_QWEN_F32_LAYERS, "torch_dtype": "float32"}


def qwen_f32_reference() -> dict:
    """Phase 27(a)'s one-card float32 reference: ``qwen_f32_hf`` seeded
    (TP_QWEN_F32_SEED) through ``Qwen2MoePolicy`` on one card, the greedy
    stream of phase 4's first prompt and the first-step logits of its
    parity prompt."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hf = qwen_f32_hf()
    policy = Qwen2MoePolicy()
    cfg = dataclasses.replace(policy.build_config(hf), dtype=torch.float32, param_dtype=torch.float32,
                              attention_impl="flash")
    state = policy.convert(seeded_hf_state(hf_shapes(hf), torch.float32, TP_QWEN_F32_SEED), cfg)
    eng = build_engine(cfg, state, engine_config(torch.float32, 256), device="cuda")
    streams = eng.generate(parity_f32_prompts(cfg.vocab_size)[:1], max_new_tokens=24)
    logits = first_step_logits(eng, parity_prompt(cfg.vocab_size)).cpu().numpy()
    del eng, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"streams": streams, "logits": logits}


def phase_mixtral_dir(smi: str) -> dict:
    """Mixtral-8x7B at its published widths, cut to MIXTRAL_LAYERS layers,
    written as safetensors and served through ``build_hf_engine`` (phase
    17's mix, K3 == layers x forwards, float32 kernel and plain streams
    identical)."""
    root = tempfile.mkdtemp(prefix="moe_")
    try:
        free = shutil.disk_usage(root).free
        log(f"  {free / 1e9:.1f} GB free under {tempfile.gettempdir()}")
        return serve_checkpoint_dir(root, "mixtral-8x7b", MIXTRAL_8X7B, MIXTRAL_LAYERS, "safetensors", 190, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def record_moe_layers(model) -> tuple:
    """Forward hooks on every ``MoE`` layer: a list each forward appends
    ``(l_aux, exp_counts, capacity)`` to (the recompute under remat too)."""
    rec = []

    def hook(mod, args, out):
        rec.append((out[1].detach(), out[2].detach(), mod.capacity(args[0].shape[0] * args[0].shape[1], True)))

    return rec, [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, MoE)]


def dropped_share(counts: torch.Tensor, capacity: int) -> float:
    """The share of the top-k choices past their expert's capacity."""
    return float(torch.clamp(counts - capacity, min=0).sum() / counts.sum())


def phase_moe_training(smi: str) -> dict:
    """``initialize`` → ``train_batch`` on Mixtral-8x7B's widths at
    MOE_TRAIN_LAYERS layer, B 2 of S 1024, bf16, AdamW, remat
    ``flash_saveable``, ``make_mixtral_loss_fn``: step ms, tokens/s, K1/K2a/K2b
    once per layer per step, the dropped share of the router's choices and
    ``l_aux``; then the float32 parity of the kernel path against the plain
    path (``moe_training_parity_f32``)."""
    cfg = dataclasses.replace(MIXTRAL_PRESETS["mixtral-8x7b"], num_hidden_layers=MOE_TRAIN_LAYERS,
                              max_position_embeddings=MOE_TRAIN_S, remat=True, remat_policy="flash_saveable",
                              attention_impl="flash")
    ids = torch.from_numpy(np.random.default_rng(20).integers(0, cfg.vocab_size, (MOE_TRAIN_B, MOE_TRAIN_S),
                                                              dtype=np.int32)).cuda()
    batch = {"input_ids": ids, "labels": ids}
    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    model = MixtralForCausalLM(cfg, device="cuda")
    init_weights_(model, torch.Generator(device="cuda").manual_seed(20))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=MOE_DS_CONFIG, device="cuda",
                                                loss_fn=make_mixtral_loss_fn(cfg))
    t_build = time.perf_counter() - t0
    rec, hooks = record_moe_layers(engine.module)
    losses = [float(engine.train_batch(batch=batch)) for _ in range(MOE_TRAIN_WARMUP)]
    t0 = time.perf_counter()
    for _ in range(MOE_TRAIN_TIMED):
        loss = engine.train_batch(batch=batch)
        losses.append(float(loss))
    step_s = (time.perf_counter() - t0) / MOE_TRAIN_TIMED
    for h in hooks:
        h.remove()
    steps = MOE_TRAIN_WARMUP + MOE_TRAIN_TIMED
    launches = (flash_fwd_cuda.launches, flash_dq_cuda.launches, flash_dkv_cuda.launches)
    layers = cfg.num_hidden_layers
    if launches != (layers * steps, ) * 3:
        raise AssertionError(f"K1/K2a/K2b launched {launches} times over {steps} steps of {layers} layers")
    if paged_attention_cuda.launches:
        raise AssertionError("the training path launched the serving kernel K3")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling on a repeated batch: {losses}")
    l_aux, counts, capacity = rec[-1]
    n_params = sum(p.numel() for p in engine.module.parameters())
    expert_params = 3 * cfg.num_local_experts * cfg.hidden_size * cfg.intermediate_size * layers
    active = n_params - expert_params * (1 - cfg.num_experts_per_tok / cfg.num_local_experts)
    tok_s = MOE_TRAIN_B * MOE_TRAIN_S / step_s
    flops_per_token = 6 * active + 12 * layers * cfg.hidden_size * MOE_TRAIN_S
    res = {"params": n_params, "active_params": active, "build_s": t_build, "step_ms": 1e3 * step_s,
           "tok_s": tok_s, "mfu_active": tok_s * flops_per_token / PEAK_FLOPS[torch.bfloat16],
           "peak_mem_gb": acc.max_memory_allocated() / 1e9, "losses": losses, "steps": steps,
           "launches": dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), launches)), "l_aux": float(l_aux),
           "capacity": capacity, "expert_counts": counts.tolist(), "dropped_share": dropped_share(counts, capacity),
           "card": smi}
    log("  MoE training: " + json.dumps(res))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    res["parity_f32"] = moe_training_parity_f32()
    return res


def moe_training_parity_f32() -> dict:
    """3 AdamW steps with clipping, float32, a 2-layer Mixtral at hidden
    1024 (16 heads of 64 on 4 KV heads, 8 experts of 2048, top-2, capacity
    factor 1.0 so that tokens are dropped), B 4, S 512: the kernel path
    against the chunked path on the same weights and batches, within phase
    7's tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = MixtralConfig(vocab_size=32000, hidden_size=1024, intermediate_size=2048, num_hidden_layers=2,
                        num_attention_heads=16, num_key_value_heads=4, max_position_embeddings=512,
                        num_local_experts=8, num_experts_per_tok=2, capacity_factor=1.0, dtype=torch.float32,
                        remat=True, remat_policy="flash_saveable")
    ds_config = {"train_batch_size": 4, "gradient_clipping": 1.0,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}}}
    rng = np.random.default_rng(21)
    batches = []
    for _ in range(3):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 512), dtype=np.int32)).cuda()
        batches.append({"input_ids": ids, "labels": ids})
    state, runs, params, dropped = None, {}, {}, {}
    for impl in ("flash", "chunked"):
        reset_launch_counts()
        model = MixtralForCausalLM(dataclasses.replace(cfg, attention_impl=impl), device="cuda")
        if state is None:
            init_weights_(model, torch.Generator(device="cuda").manual_seed(21))
            state = {k: v.clone() for k, v in model.state_dict().items()}
        eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=ds_config, params=state, device="cuda",
                                                 loss_fn=make_mixtral_loss_fn(cfg))
        rec, hooks = record_moe_layers(eng.module)
        runs[impl] = run_steps(eng, batches)
        for h in hooks:
            h.remove()
        dropped[impl] = max(dropped_share(c, cap) for _, c, cap in rec)
        params[impl] = {k: v.clone() for k, v in eng.module.state_dict().items()}
        if (flash_fwd_cuda.launches > 0) != (impl == "flash"):
            raise AssertionError(f"{impl}: K1 launched {flash_fwd_cuda.launches} times")
        del eng, model
    d = run_differences(runs["flash"], runs["chunked"])
    diff = torch.cat([(params["flash"][k] - params["chunked"][k]).abs().flatten() for k in params["flash"]])
    res = {"losses_kernel": runs["flash"]["losses"], "losses_plain": runs["chunked"]["losses"],
           "grad_norms_kernel": runs["flash"]["grad_norms"], "kernel_vs_plain": d, "max_param_abs": float(diff.max()),
           "share_param_beyond_2e-5": float((diff > 2e-5).float().mean()), "max_dropped_share": dropped}
    log("  f32 MoE training parity (hidden 1024, 2 layers, drops): " + json.dumps(res))
    if not (d["loss"] <= 1e-5 and d["grad_norm"] <= 1e-5 and max(d["qkv_grads"].values()) <= 1e-5
            and res["share_param_beyond_2e-5"] < 1e-4 and res["max_param_abs"] <= 2 * 3e-4
            and min(dropped.values()) > 0):
        raise AssertionError(f"f32 MoE training parity out of tolerance (or no token dropped): {res}")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phases 21-23

# EleutherAI/pythia-6.9b's config.json, in code (the weights are seeded)
PYTHIA_6_9B = {"model_type": "gpt_neox", "vocab_size": 50432, "hidden_size": 4096, "intermediate_size": 16384,
               "num_hidden_layers": 32, "num_attention_heads": 32, "rotary_pct": 0.25, "rotary_emb_base": 10000,
               "use_parallel_residual": True, "layer_norm_eps": 1e-5, "max_position_embeddings": 2048,
               "hidden_act": "gelu", "tie_word_embeddings": False, "torch_dtype": "float16"}
# EleutherAI/gpt-j-6b's (head dim 256: kernel injection must refuse it)
GPTJ_6B = {"model_type": "gptj", "vocab_size": 50400, "n_embd": 4096, "n_layer": 28, "n_head": 16, "rotary_dim": 64,
           "n_positions": 2048, "layer_norm_epsilon": 1e-5, "activation_function": "gelu_new",
           "tie_word_embeddings": False, "torch_dtype": "float32"}
V1_PROMPTS, V1_PROMPT_LEN, V1_NEW = 4, 448, 64       # one [4, 512] buffer: every forward takes K1
GPT2_B, GPT2_S, GPT2_STEPS = 8, 1024, 5
GPT2_DS_CONFIG = {"train_batch_size": GPT2_B, "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                                                                     "weight_decay": 0.01}},
                  "gradient_clipping": 1.0, "bf16": {"enabled": True}, "steps_per_print": 0}
# phase 23: each published config.json in code, with its checkpoint's dtype;
# the layer-count fields each family's config cuts
V1_ZOO = {
    "bloom-7b1": ({"model_type": "bloom", "vocab_size": 250880, "hidden_size": 4096, "n_layer": 30, "n_head": 32,
                   "layer_norm_epsilon": 1e-5, "tie_word_embeddings": True, "torch_dtype": "float16"},
                  torch.float16, ("n_layer", )),
    "pythia-6.9b": (PYTHIA_6_9B, torch.float16, ("num_hidden_layers", )),
    "gpt-j-6b": (GPTJ_6B, torch.float32, ("n_layer", )),
    "gpt-neo-2.7B": ({"model_type": "gpt_neo", "vocab_size": 50257, "hidden_size": 2560, "num_layers": 32,
                      "num_heads": 20, "intermediate_size": None, "max_position_embeddings": 2048,
                      "attention_layers": ["global", "local"] * 16, "window_size": 256, "layer_norm_epsilon": 1e-5,
                      "torch_dtype": "float32"}, torch.float32, ("num_layers", )),
    "bert-large-uncased": ({"model_type": "bert", "vocab_size": 30522, "hidden_size": 1024, "num_hidden_layers": 24,
                            "num_attention_heads": 16, "intermediate_size": 4096, "max_position_embeddings": 512,
                            "type_vocab_size": 2, "layer_norm_eps": 1e-12, "hidden_act": "gelu",
                            "position_embedding_type": "absolute", "torch_dtype": "float32"},
                           torch.float32, ("num_hidden_layers", )),
    "clip-vit-large-patch14": ({"model_type": "clip", "projection_dim": 768, "torch_dtype": "float32",
                                "text_config": {"vocab_size": 49408, "hidden_size": 768, "intermediate_size": 3072,
                                                "num_attention_heads": 12, "num_hidden_layers": 12,
                                                "max_position_embeddings": 77, "layer_norm_eps": 1e-5,
                                                "hidden_act": "quick_gelu", "eos_token_id": 2},
                                "vision_config": {"hidden_size": 1024, "intermediate_size": 4096,
                                                  "num_attention_heads": 16, "num_hidden_layers": 24,
                                                  "image_size": 224, "patch_size": 14, "num_channels": 3,
                                                  "layer_norm_eps": 1e-5, "hidden_act": "quick_gelu"}},
                               torch.float32, ("text_config.num_hidden_layers", "vision_config.num_hidden_layers")),
}
V1_ZOO_LAYERS = 2
# float32 on the card (TF32 off) against the port's CPU forward: the two
# sum their matmuls in other orders, ~1e-6 relative a product, so the
# outputs of two layers and the head agree within 1e-4 of their largest
# magnitude
V1_F32_TOL = 1e-4


def seed_weights_(model, seed: int, device="cuda"):
    """Seeded weights for any model: matrices (and embeddings, the patch
    kernel) N(0, 1/fan_in), norm scales 1, biases and the other vectors
    N(0, 0.02²)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, p[0].numel()**-0.5, generator=gen)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def f32_stream_differences(model, prompts, got, want) -> list:
    """Where stream ``got`` leaves ``want``: the position and the top-2
    margin of ``model``'s logits there; a tie when the margin is within
    TIE_MARGIN of the top logit (phase 13's float32 criterion)."""
    out = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        with torch.no_grad():
            logits = model(torch.tensor([list(p) + list(b[:j])], device=next(model.parameters()).device))[0, -1]
        top = torch.topk(logits.float(), 2).values
        out.append({"row": i, "position": j, "tie": float(top[0] - top[1]) <= TIE_MARGIN * abs(float(top[0]))})
    return out


def train_gpt2(smi: str) -> dict:
    """GPT-2 (124M, ``gpt2``'s config) through ``initialize`` with
    ``attention_impl="flash"``: B 8, S 1024, bf16, 5 steps; K1/K2a/K2b once
    per layer a step (remat ``flash_saveable``), losses finite."""
    cfg = dataclasses.replace(GPT2_PRESETS["gpt2-125m"], attention_impl="flash", remat=True,
                              remat_policy="flash_saveable")
    model = init_weights_(GPT2LMHeadModel(cfg, device="cuda"), torch.Generator(device="cuda").manual_seed(21))
    engine = deepspeed_tpu_torch.initialize(model=model, config=GPT2_DS_CONFIG, device="cuda")[0]
    rng = np.random.default_rng(21)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (GPT2_B, GPT2_S), dtype=np.int64)).cuda()
               for _ in range(GPT2_STEPS)]
    reset_launch_counts()
    losses, times = [], []
    for ids in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch={"input_ids": ids, "labels": ids})))
        times.append(time.perf_counter() - t0)
    launches = {"flash_fwd": flash_fwd_cuda.launches, "flash_dq": flash_dq_cuda.launches,
                "flash_dkv": flash_dkv_cuda.launches}
    layers = cfg.num_hidden_layers
    step_s = float(np.median(times[1:]))
    res = {"params": sum(p.numel() for p in engine.params), "losses": losses, "step_ms": 1e3 * step_s,
           "tok_s": GPT2_B * GPT2_S / step_s, "launches": launches, "card": smi}
    log("  GPT-2 training: " + json.dumps(res))
    if launches != dict.fromkeys(launches, layers * GPT2_STEPS):
        raise AssertionError(f"K1/K2a/K2b launched {launches} over {GPT2_STEPS} steps of {layers} layers")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"GPT-2 losses not finite: {losses}")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_v1_engine(smi: str) -> dict:
    """The v1 engine at full width and depth: GPT-NeoX at pythia-6.9b's
    config with seeded bf16 weights, ``init_inference`` with kernel
    injection, ``generate`` 64 tokens for 4 prompts of 448 (one [4, 512]
    buffer: every forward through K1, 32 launches a forward); the same
    weights on the plain path and in float32 (phase 4's bound on the bf16
    logits), float32 greedy streams at 2 layers identical on both paths,
    GPT-J (head dim 256) refused by injection; then GPT-2 training."""
    cfg = gpt_family.GPTNeoXConfig.from_hf(PYTHIA_6_9B, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    layers = cfg.num_hidden_layers
    model = seed_weights_(gpt_family.GPTNeoXForCausalLM(cfg, device="cuda"), seed=22)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    eng = deepspeed_tpu_torch.init_inference(model=model, config={"dtype": "bf16", "replace_with_kernel_inject": True},
                                             device="cuda")
    if eng.module.cfg.attention_impl != "flash":
        raise AssertionError("kernel injection did not select the flash attention")
    rng = np.random.default_rng(22)
    prompts = rng.integers(0, cfg.vocab_size, (V1_PROMPTS, V1_PROMPT_LEN))
    eng.generate(prompts, max_new_tokens=2)                               # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, max_new_tokens=V1_NEW)                  # ends in its readback
    wall = time.perf_counter() - t0
    launches = flash_fwd_cuda.launches
    res = {"weight_bytes": nbytes, "layers": layers, "head_dim": cfg.head_dim, "buffer": list(tokens.shape),
           "forwards": V1_NEW, "k1_launches": launches, "ms_per_forward": 1e3 * wall / V1_NEW,
           "tok_s": V1_PROMPTS * V1_NEW / wall, "card": smi}
    checks = {"k1_launches_layers_x_forwards": launches == layers * V1_NEW,
              "tokens_shape": tokens.shape == (V1_PROMPTS, V1_PROMPT_LEN + V1_NEW)}

    # phase 4's bound: the bf16 logits of the kernel path and of the plain
    # path on the same weights, both against float32
    ids = torch.from_numpy(tokens[:, :V1_PROMPT_LEN + V1_NEW]).cuda()
    plain = deepspeed_tpu_torch.init_inference(model=model, config={"dtype": "bf16"}, device="cuda")
    logits = {"flash": eng.forward(ids)[:, -1].float(), "reference": plain.forward(ids)[:, -1].float()}
    del plain
    f32 = gpt_family.GPTNeoXForCausalLM(dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32),
                                        device="meta")
    f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()}, strict=True, assign=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        logits["f32"] = f32(ids)[:, -1].float()
    del f32
    torch.cuda.empty_cache()
    e = rel_l2(logits["reference"], logits["f32"])
    parity = {"kernel_vs_plain": rel_l2(logits["flash"], logits["reference"]),
              "kernel_vs_f32": rel_l2(logits["flash"], logits["f32"]), "plain_vs_f32": e}
    res["bf16_parity"] = parity
    checks["bf16_logits_within_phase_4_bound"] = (parity["kernel_vs_plain"] <= 2 * e
                                                  and parity["kernel_vs_f32"] <= 1.5 * e)
    # phase 27(a)'s one-card reference for the v1 engine over tensor 2: the kernel path's last-position logits
    # of the buffer's first row, and a short greedy buffer (the first prompt's first V1_TP_PROMPT_LEN tokens,
    # V1_TP_NEW new) with its logits at each new position
    short = prompts[:1, :V1_TP_PROMPT_LEN]
    short_tokens = eng.generate(short, max_new_tokens=V1_TP_NEW)
    short_logits = eng.forward(torch.from_numpy(short_tokens).cuda())[0, V1_TP_PROMPT_LEN - 1:-1].float()
    tp_ref = {"ids": ids[:1].cpu().numpy(), "logits": logits["flash"][:1].cpu().numpy(),
              "f32_logits": logits["f32"][:1].cpu().numpy(), "e": e, "short_prompt": short,
              "short_tokens": short_tokens, "short_logits": short_logits.cpu().numpy(),
              "n_params": sum(p.numel() for p in model.parameters())}
    del eng, model, logits, short_logits
    gc.collect()
    torch.cuda.empty_cache()

    # float32 at 2 layers: greedy streams identical on the kernel and plain paths
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2, dtype=torch.float32, param_dtype=torch.float32)
    small = seed_weights_(gpt_family.GPTNeoXForCausalLM(cfg2, device="cuda"), seed=23)
    streams = {}
    for name, inject in (("flash", True), ("reference", False)):
        e2 = deepspeed_tpu_torch.init_inference(model=small, config={"dtype": "fp32",
                                                                     "replace_with_kernel_inject": inject},
                                                device="cuda")
        reset_launch_counts()
        streams[name] = e2.generate(prompts, max_new_tokens=V1_NEW)[:, V1_PROMPT_LEN:].tolist()
        if inject:
            checks["f32_k1_launches"] = flash_fwd_cuda.launches == 2 * V1_NEW
    res["f32_differences"] = f32_stream_differences(small, prompts.tolist(), streams["flash"], streams["reference"])
    checks["f32_streams_identical"] = streams["flash"] == streams["reference"]
    del small, e2
    # GPT-J at head dim 256: injection refuses it
    gptj = gpt_family.GPTJForCausalLM(gpt_family.GPTJConfig.from_hf(GPTJ_6B), device="meta")
    try:
        deepspeed_tpu_torch.init_inference(model=gptj, config={"replace_with_kernel_inject": True}, device="cuda")
        checks["gptj_injection_raises"] = False
    except NotImplementedError as err:
        res["gptj_injection"] = str(err)
        checks["gptj_injection_raises"] = "head dim 256" in str(err) and "item 5" in str(err)
    log("  v1 engine: " + json.dumps(res))
    gc.collect()
    torch.cuda.empty_cache()
    res["gpt2_training"] = train_gpt2(smi)
    res["checks"] = checks
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"v1 engine phase failed {bad}: {json.dumps(res)}")
    res["tp_reference"] = tp_ref
    return res


def k4b_block128_bf16(node: dict, shape, flush) -> dict:
    """K4b at block 128 with its bf16 store on one quantized weight: equal to
    the plain version (the float32 product rounded once to bf16), timed cold
    beside the bound (codes and scales read once, the bf16 written once)."""
    q, s = node["q"], node["scale"]
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.bfloat16, device="cuda")
    dequantize_int8_cuda(q, s, shape, out=out)
    want = dequantize_int8_plain(q, s, shape).to(torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(out.view(shape), want):
        raise AssertionError(f"K4b's bf16 store differs from the plain version at {tuple(shape)}")
    nbytes = q.numel() + 4 * s.numel() + 2 * n
    return {"shape": list(shape), "max_abs_err": 0.0,
            "ms": time_ms(lambda: dequantize_int8_cuda(q, s, shape, out=out), 20, flush),
            "plain_ms": time_ms(lambda: dequantize_int8_plain(q, s, shape).to(torch.bfloat16), 5, flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


# phase 22's leaves quantized on the card and again on the CPU, bit for bit
INT8_CPU_LEAVES = ("embed_tokens.weight", "layers.0.self_attn.q_proj.weight", "layers.0.mlp.down_proj.weight")


def int8_codes_match_cpu(qp, state) -> dict:
    """The card's codes and scales of INT8_CPU_LEAVES against
    ``_quantize_leaf`` of the same bf16 tensors on the CPU (the arithmetic
    the CPU tests hold bit-identical to the JAX package's), bit for bit."""
    out = {}
    for name in INT8_CPU_LEAVES:
        t = state[name].cpu()
        want = _quantize_leaf(t.t() if name in qp.transposed else t, qp.group)
        got = qp.tree[name]
        out[name] = (torch.equal(got["q"].cpu(), want["q"])
                     and torch.equal(got["scale"].cpu().view(torch.int32), want["scale"].view(torch.int32)))
    return out


def int8_weight_errors(qp, state, deq) -> dict:
    """Each quantized tensor's relative error ||deq - W|| / ||W|| beside the
    most int8 rounding allows, computed from the bf16 weights W alone (not
    from the codes): a code is off by at most half its group's step, scale/2
    with scale = amax/127, and the bf16 store rounds the product by at most
    2^-9 of itself, so ||deq - W|| <= q + 2^-9 (||W|| + q) with q =
    sqrt(sum over groups of 128 (scale/2)^2).  The bound is widened by 1e-3
    of itself for the float32 sums."""
    res = {}
    for name, shape in qp.shapes.items():
        w = state[name].float()
        g = (w.t() if name in qp.transposed else w).reshape(-1)
        g = torch.nn.functional.pad(g, (0, (-g.numel()) % qp.group)).view(-1, qp.group)
        q = float(((g.abs().amax(dim=1) / 127 / 2)**2).sum().mul(qp.group).sqrt())
        norm = float(w.norm())
        err = float((deq[name].float() - w).norm())
        res[name] = (err / norm, (q + 2**-9 * (norm + q)) / norm * 1.001)
    return res


def phase_int8_serving(cfg, state, smi: str, bf16_rounding: float) -> dict:
    """Weight-only int8 serving of Llama-3-8B (phase 3's weights, before they
    are freed): ``quantize_inference_params`` on the card, phase 3's mix
    through ``InferenceEngineV2`` (K3 == layers x forwards, K4b == the
    quantized tensors x forwards, every step a CUDA graph), a profiled decode
    round, the greedy streams against a bf16 engine over the same weights
    dequantized once (equal but for rounding ties), and K4b's block-128
    bf16 store against its plain version."""
    t0 = time.perf_counter()
    qp = quantize_inference_params(state, dtype=torch.bfloat16, cfg=cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    bf16_bytes = sum(t.numel() * t.element_size() for t in state.values())
    leaves = len(qp.shapes)
    eng = build_engine(cfg, qp, engine_config(torch.bfloat16, 1024), device="cuda")
    prompts, max_new = serving_mix(cfg.vocab_size)
    serving = serve_mix(eng, prompts, max_new, smi)
    k4b = dequantize_int8_cuda.launches
    graphs = [hasattr(prog, "graph") for prog in eng._step_fns.values()]
    res = {"quantize_s": quant_s, "quantized_tensors": leaves, "resident_weight_bytes": qp.nbytes,
           "bf16_weight_bytes": bf16_bytes, "resident_share": qp.nbytes / bf16_bytes,
           "scratch_bytes": eng.dequantizer.scratch_bytes,
           "with_scratch_share": (qp.nbytes + eng.dequantizer.scratch_bytes) / bf16_bytes,
           "serving": serving, "k4b_launches": k4b,
           "step_programs": len(graphs), "card": smi}
    checks = {"k4b_quantized_tensors_x_forwards": k4b == leaves * serving["forwards"] > 0,
              "steps_are_graphs": len(graphs) > 0 and all(graphs),
              "resident_at_most_55_percent": qp.nbytes <= 0.55 * bf16_bytes}
    codes = int8_codes_match_cpu(qp, state)
    res["codes_equal_cpu"] = codes
    checks["codes_and_scales_equal_cpu"] = all(codes.values())
    int8_streams = serve_greedy(eng, prompts, max_new)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 200).tolist()
    int8_logits = first_step_logits(eng, prompt)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res["profile"] = phase_profile(cfg, qp)
    deq = qp.dequantize()
    # every tensor within int8 rounding of phase 3's weights; and the logits:
    # each tensor's error moves them by at most its own relative size (the
    # norms rescale the residual stream; a tensor's output is a part of it),
    # and the tensors' errors are independent, so they add in quadrature
    errors = int8_weight_errors(qp, state, deq)
    worst = max(errors, key=lambda k: errors[k][0] / errors[k][1])
    ref = build_engine(cfg, state, engine_config(cfg.dtype, 64), device="cuda")
    bf16_logits = first_step_logits(ref, prompt)
    del ref
    logits_rel = float((int8_logits - bf16_logits).norm() / bf16_logits.norm())
    # plus phase 4's allowance for two bf16 paths' own rounding (2e)
    logits_bound = math.sqrt(sum(b**2 for _, b in errors.values())) + 2 * bf16_rounding
    res["weight_error"] = {"worst_share_of_bound": errors[worst][0] / errors[worst][1], "worst": worst,
                           "embed_tokens": list(errors["embed_tokens.weight"])}
    res["logits_vs_bf16_weights"] = {"relative_l2": logits_rel, "bound": logits_bound}
    checks["each_tensor_within_int8_rounding"] = all(e <= b for e, b in errors.values())
    checks["logits_within_int8_rounding"] = logits_rel <= logits_bound
    plain = build_engine(cfg, deq, engine_config(torch.bfloat16, 1024), device="cuda")
    bf16_streams = serve_greedy(plain, prompts, max_new)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    diffs = first_difference_margins(cfg, deq, prompts, {"spec": int8_streams, "plain": bf16_streams})
    res["stream_differences"] = [{"request": d["request"], "position": d["position"],
                                  "gap_ulps": d["spec_gap"] / bf16_ulp(d["top_logit"])} for d in diffs]
    checks["streams_equal_but_ties"] = all(d["spec_gap"] <= BF16_TIE_ULPS * bf16_ulp(d["top_logit"]) for d in diffs)
    del deq
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    res["k4b_bf16"] = {name: k4b_block128_bf16(qp.tree[name], qp.shapes[name], flush)
                       for name in ("embed_tokens.weight", "layers.0.mlp.down_proj.weight")}
    del flush, qp
    gc.collect()
    torch.cuda.empty_cache()
    res["checks"] = checks
    log("  int8 serving: " + json.dumps(res))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"int8 serving phase failed {bad}")
    return res


def cut_layers(hf: dict, fields, layers: int) -> dict:
    """The config with each layer-count field (``a.b`` for a nested one) at
    ``layers``; GPT-Neo's ``attention_layers`` cut with it."""
    hf = copy.deepcopy(hf)
    for field in fields:
        node = hf
        *path, last = field.split(".")
        for key in path:
            node = node[key]
        node[last] = layers
    if "attention_layers" in hf:
        hf["attention_layers"] = hf["attention_layers"][:layers]
    return hf


def v1_inputs(model_type: str, hf: dict, seed: int) -> tuple:
    """The forward's inputs: 2 rows of 16 token ids (CLIP's text holds its
    EOS id, and 224-pixel NHWC images)."""
    rng = np.random.default_rng(seed)
    if model_type == "clip":
        text = hf["text_config"]
        ids = rng.integers(3, text["vocab_size"], (2, 16))
        ids[:, 9] = text["eos_token_id"]
        vision = hf["vision_config"]
        pixels = rng.normal(size=(2, vision["image_size"], vision["image_size"], vision["num_channels"]))
        return torch.from_numpy(ids), torch.from_numpy(pixels.astype(np.float32))
    return (torch.from_numpy(rng.integers(0, hf["vocab_size"], (2, 16))), )


def serve_v1_dir(root: str, name: str, seed: int, smi: str, layers: int = V1_ZOO_LAYERS, device="cuda") -> dict:
    """One v1 checkpoint at its published widths, cut to ``layers`` layers:
    seeded weights in the published dtype under HF's names, written to a
    directory, served by ``build_hf_engine``'s fp32 v1 route on ``device``
    and on the CPU; outputs within V1_F32_TOL of the CPU's, and the causal
    models' greedy streams equal but for float32 ties."""
    published, dtype, fields = V1_ZOO[name]
    hf = cut_layers(published, fields, layers)
    policy = policy_for(hf["model_type"])
    t0 = time.perf_counter()
    model = seed_weights_(policy.build_model(policy.build_config(hf), device=device), seed, device)
    probe = {"transformer.": None, "cls.predictions.decoder.weight": None, "cls.predictions.decoder.bias": None}
    state = {policy.hf_name(k, probe): v.to(dtype) for k, v in model.state_dict().items()}
    del model
    path = os.path.join(root, name)
    nbytes = write_checkpoint(path, hf, state, "safetensors")
    del state
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = build_hf_engine(path, device=device)
    t_load = time.perf_counter() - t0
    ref = build_hf_engine(path, device="cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False            # CLIP's patch convolution
    inputs = v1_inputs(hf["model_type"], hf, seed)
    got, want = eng.forward(*inputs), ref.forward(*inputs)
    got, want = (got, want) if isinstance(got, tuple) else ((got, ), (want, ))
    errs = [float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    res = {"layers": layers, "dtype": str(dtype), "weight_bytes": nbytes, "write_s": t_write, "load_s": t_load,
           "engine": type(eng).__name__, "max_err_of_max": max(errs), "card": smi}
    ok = type(eng).__name__ == "InferenceEngine" and max(errs) <= V1_F32_TOL and all(
        bool(torch.isfinite(g).all()) for g in got)
    if hf["model_type"] not in ("bert", "clip"):
        streams = [e.generate(inputs[0].numpy(), max_new_tokens=8)[:, 16:].tolist() for e in (eng, ref)]
        res["stream_differences"] = f32_stream_differences(ref.module, inputs[0].tolist(), *streams)
        res["streams_equal"] = streams[0] == streams[1]
        ok = ok and all(d["tie"] for d in res["stream_differences"])
    res["ok"] = ok
    log(f"  {name} ({layers} layers, {dtype}): {nbytes / 1e9:.2f} GB written in {t_write:.2f} s, "
        f"build_hf_engine {t_load:.2f} s: " + json.dumps(res))
    del eng, ref
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(path)
    return res


def phase_v1_zoo(smi: str, device="cuda") -> dict:
    """The v1 families through ``build_hf_engine`` from directories
    (``serve_v1_dir``): BLOOM-7b1, Pythia-6.9B, GPT-J-6B, GPT-Neo-2.7B,
    BERT-large and CLIP-ViT-L/14, each cut to V1_ZOO_LAYERS layers
    (``device="cpu"`` rehearses the phase against itself on the CPU)."""
    root = tempfile.mkdtemp(prefix="v1_zoo_")
    try:
        out = {name: serve_v1_dir(root, name, 230 + i, smi, device=device) for i, name in enumerate(V1_ZOO)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bad = [name for name, r in out.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"v1 families off their CPU forward: {bad}")
    return out


# ---------------------------------------------------------------- phase 24

# internlm/internlm-7b's config.json, in code (q/k/v and o_proj biases)
INTERNLM_7B = {"model_type": "internlm", "vocab_size": 103168, "hidden_size": 4096, "intermediate_size": 11008,
               "num_hidden_layers": 32, "num_attention_heads": 32, "max_position_embeddings": 2048,
               "rms_norm_eps": 1e-6, "bias": True, "torch_dtype": "float16"}
ZOO_TRAIN_B, ZOO_TRAIN_S = 2, 2048         # Phi-2 at full width and depth
# one timed step (three until phase 26 needed the room)
ZOO_TRAIN_WARMUP, ZOO_TRAIN_TIMED = 2, 1
ZOO_TRAIN_DS_CONFIG = {"train_batch_size": ZOO_TRAIN_B, "optimizer": {"type": "AdamW",
                                                                      "params": {"lr": 1e-4, "weight_decay": 0.01}},
                       "bf16": {"enabled": True}, "steps_per_print": 0}
# the 2-layer rows: published config, sequence length, and why K1 does not
# run where it does not (JAX runs no kernel there either).  Phi-3-mini-4k's
# 2047-key window is dropped so that K1 takes its head dim 96 (with it, its
# training takes the chunked path, as Mistral's does)
ZOO_TRAIN = {
    "phi-3-mini-4k": ({**ZOO["phi-3-mini-4k"][0], "sliding_window": 0}, 2048, None),
    "falcon-7b": (FALCON_7B, 2048, None),
    "falcon-rw-1b": (ZOO["falcon-rw-1b"][0], 2048, "alibi: the plain attention with the bias, as JAX"),
    "opt-6.7b": (ZOO["opt-6.7b"][0], 2048, None),
    "mistral-7b-v0.1": (ZOO["mistral-7b-v0.1"][0], 8192, "window 4096 < S: the chunked path, as JAX"),
    "qwen2-7b": (ZOO["qwen2-7b"][0], 2048, None),
    "internlm-7b": (INTERNLM_7B, 2048, None),
}
ZOO_TRAIN_BF16_STEPS = 3


def training_model(cfg, device="cuda"):
    """The cache-free training model of a config's family."""
    models = {FalconConfig: FalconForCausalLM, OPTConfig: OPTForCausalLM, PhiConfig: PhiForCausalLM,
              LlamaConfig: LlamaForCausalLM}
    return models[type(cfg)](cfg, device=device)


def flash_launches() -> tuple:
    return flash_fwd_cuda.launches, flash_dq_cuda.launches, flash_dkv_cuda.launches


def train_phi_2(smi: str) -> dict:
    """Phi-2 (``microsoft/phi-2``'s published config: hidden 2560, 32 heads
    of 80, vocab 51200) at full depth through ``initialize`` →
    ``train_batch``: bf16, AdamW, remat ``flash_saveable``, seeded weights,
    B 2 of S 2048; step ms, tokens/s, MFU (``bench.py:160-162``), and
    K1/K2a/K2b once per layer per step at head dim 80."""
    hf = ZOO["phi-2"][0]
    cfg = dataclasses.replace(policy_for("phi").build_config(hf), remat=True, remat_policy="flash_saveable",
                              attention_impl="flash")
    layers = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(24).integers(0, cfg.vocab_size, (ZOO_TRAIN_B, ZOO_TRAIN_S),
                                                              dtype=np.int32)).cuda()
    batch = {"input_ids": ids, "labels": ids}
    acc = get_accelerator()
    acc.synchronize()
    acc.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = seed_weights_(training_model(cfg), seed=24)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=ZOO_TRAIN_DS_CONFIG, device="cuda")
    t_build = time.perf_counter() - t0
    reset_launch_counts()
    losses = [float(engine.train_batch(batch=batch)) for _ in range(ZOO_TRAIN_WARMUP)]
    t0 = time.perf_counter()
    for _ in range(ZOO_TRAIN_TIMED):
        loss = engine.train_batch(batch=batch)
    losses.append(float(loss))                                            # the value fetch syncs
    step_s = (time.perf_counter() - t0) / ZOO_TRAIN_TIMED
    steps = ZOO_TRAIN_WARMUP + ZOO_TRAIN_TIMED
    launches = flash_launches()
    n_params = sum(p.numel() for p in engine.module.parameters())
    tok_s = ZOO_TRAIN_B * ZOO_TRAIN_S / step_s
    flops_per_token = 6 * n_params + 12 * layers * cfg.hidden_size * ZOO_TRAIN_S
    res = {"params": n_params, "layers": layers, "head_dim": cfg.head_dim, "build_s": t_build,
           "step_ms": 1e3 * step_s, "tok_s": tok_s, "mfu": tok_s * flops_per_token / PEAK_FLOPS[torch.bfloat16],
           "peak_mem_gb": acc.max_memory_allocated() / 1e9, "losses": losses, "steps": steps,
           "launches": dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), launches)), "card": smi}
    log("  Phi-2 training: " + json.dumps(res))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    if launches != (layers * steps, ) * 3:
        raise AssertionError(f"Phi-2: K1/K2a/K2b launched {launches} times over {steps} steps of {layers} layers")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"Phi-2: losses not finite and falling on a repeated batch: {losses}")
    return res


def f64_run(cfg, state, batch) -> dict:
    """The first batch's loss, global grad norm and q/k/v gradients of the
    plain path in float64 (``run_steps``'s first step, without the engine)."""
    model = training_model(dataclasses.replace(cfg, dtype=torch.float64, param_dtype=torch.float64))
    model.load_state_dict({k: v.double() for k, v in state.items()})
    loss = causal_lm_loss(model(batch["input_ids"]), batch["labels"])
    loss.backward()
    run = {"losses": [float(loss)], "grads": {n: p.grad for n, p in model.named_parameters() if n.split(".")[-2] in QKV},
           "grad_norms": [math.sqrt(sum(float(p.grad.square().sum()) for p in model.parameters()))]}
    del model
    return run


def zoo_training_row(name: str, smi: str) -> dict:
    """One family at its published widths cut to ZOO_LAYERS layers, B 1:
    one float32 AdamW step (clipping) on the kernel path and on the plain
    path (``chunked``) from the same seeded weights, held to phase 7's
    tolerances, then ZOO_TRAIN_BF16_STEPS bf16 steps with finite losses;
    K1/K2a/K2b once per layer per step on the kernel path (0 where the
    family's attention takes no kernel, with the reason).

    Phase 7's float32 rule (loss, grad norm and each q/k/v gradient within
    1e-5 relative of the plain path) assumes that float32 rounding moves
    those by less.  At OPT's seeded widths it does not: both float32 paths
    lie ~1.4e-3 from the float64 gradients of the attention projections (a
    ReLU MLP's common component in every token's K and V makes the
    backward cancel), so a measure passes either by that rule or by phase
    7's bf16 rule one precision up — the kernel path within 1.5× the plain
    path's own distance to the float64 plain path.  The key bias's gradient
    is zero up to rounding (it shifts a row's scores alike) and is not
    compared."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hf, seq, no_kernel = ZOO_TRAIN[name]
    cfg = policy_for(hf["model_type"]).build_config(cut_layers(hf, ["num_hidden_layers"], ZOO_LAYERS))
    kernel_impl = "reference" if getattr(cfg, "alibi", False) else "flash"
    plain_impl = kernel_impl if kernel_impl == "reference" else "chunked"
    cfg = dataclasses.replace(cfg, dtype=torch.float32, remat=True, remat_policy="flash_saveable",
                              attention_impl=kernel_impl)
    ds_config = {"train_batch_size": 1, "gradient_clipping": 1.0, "steps_per_print": 0,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-5, "weight_decay": 0.01}}}
    rng = np.random.default_rng(25)
    batches = []
    for _ in range(1 + ZOO_TRAIN_BF16_STEPS):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, seq), dtype=np.int32)).cuda()
        batches.append({"input_ids": ids, "labels": ids})
    model = seed_weights_(training_model(cfg), seed=25)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    t0 = time.perf_counter()
    runs, launches = {}, {}
    for path, impl in (("kernel", kernel_impl), ("plain", plain_impl)):
        reset_launch_counts()
        eng, *_ = deepspeed_tpu_torch.initialize(model=training_model(dataclasses.replace(cfg, attention_impl=impl)),
                                                 config=ds_config, params=state, device="cuda")
        runs[path] = run_steps(eng, batches[:1])
        launches[path] = flash_launches()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    runs["f64"] = f64_run(dataclasses.replace(cfg, attention_impl=plain_impl), state, batches[0])
    gc.collect()
    torch.cuda.empty_cache()
    for run in runs.values():
        run["grads"] = {n: g for n, g in run["grads"].items() if not n.endswith("k_proj.bias")}
    d = run_differences(runs["kernel"], runs["plain"])
    e_kernel, e_plain = run_differences(runs["kernel"], runs["f64"]), run_differences(runs["plain"], runs["f64"])
    within = {m: d[m] <= 1e-5 or e_kernel[m] <= 1.5 * e_plain[m] for m in ("loss", "grad_norm")}
    within.update({n: d["qkv_grads"][n] <= 1e-5 or e_kernel["qkv_grads"][n] <= 1.5 * e_plain["qkv_grads"][n]
                   for n in d["qkv_grads"]})
    reset_launch_counts()
    eng, *_ = deepspeed_tpu_torch.initialize(model=training_model(dataclasses.replace(cfg, dtype=torch.bfloat16)),
                                             config={**ds_config, "bf16": {"enabled": True}}, params=state,
                                             device="cuda")
    bf16_losses = [float(eng.train_batch(batch=b)) for b in batches[1:]]
    bf16_launches = flash_launches()
    n_params = sum(p.numel() for p in eng.module.parameters())
    del eng, state
    gc.collect()
    torch.cuda.empty_cache()
    layers = cfg.num_hidden_layers
    # run_steps: one forward and backward for the grads, then one train_batch
    want_f32 = (0, 0, 0) if no_kernel else (2 * layers, ) * 3
    want_bf16 = (0, 0, 0) if no_kernel else (layers * ZOO_TRAIN_BF16_STEPS, ) * 3
    heads = (cfg.num_attention_heads, getattr(cfg, "num_key_value_heads",
                                              getattr(cfg, "num_kv_heads", cfg.num_attention_heads)))
    res = {"params": n_params, "layers": layers, "seq": seq, "head_dim": cfg.head_dim, "heads": heads,
           "attention": no_kernel or "K1/K2a/K2b", "loss_f32": runs["kernel"]["losses"][0],
           "kernel_vs_plain_f32": d, "kernel_vs_f64": e_kernel, "plain_vs_f64": e_plain, "bf16_losses": bf16_losses,
           "launches_f32": dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), launches["kernel"])),
           "launches_bf16": dict(zip(("flash_fwd", "flash_dq", "flash_dkv"), bf16_launches)),
           "seconds": time.perf_counter() - t0, "card": smi}
    log(f"  {name} training ({layers} layers, S {seq}): " + json.dumps(res))
    if launches["kernel"] != want_f32 or bf16_launches != want_bf16 or any(launches["plain"]):
        raise AssertionError(f"{name}: K1/K2a/K2b launched {launches} (f32) and {bf16_launches} (bf16), expected "
                             f"{want_f32} on the kernel path, {want_bf16} in bf16 and none on the plain path")
    if not all(within.values()):
        raise AssertionError(f"{name}: f32 kernel path out of phase 7's tolerances: "
                             f"{sorted(m for m, ok in within.items() if not ok)}")
    if not all(np.isfinite(bf16_losses)):
        raise AssertionError(f"{name}: bf16 losses not finite: {bf16_losses}")
    return res


def phase_zoo_training(smi: str) -> dict:
    res = {"phi-2": train_phi_2(smi)}
    for name in ZOO_TRAIN:
        res[name] = zoo_training_row(name, smi)
    res["launches"] = {k: res["phi-2"]["launches"][k] + sum(res[n]["launches_f32"][k] + res[n]["launches_bf16"][k]
                                                            for n in ZOO_TRAIN)
                       for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible; the port's smoke run needs one", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    log("== phase 1: environment")
    env = phase_environment()
    log("== phase 2: K3 paged attention vs its plain version")
    k3 = phase_kernels()
    log("== phase 3: serving Llama-3-8B")
    cfg, state = llama3_8b(32, torch.bfloat16, seed=0)
    serving = phase_serving(cfg, state, env["card"])
    phase_profile(cfg, state)
    log("== phase 4: path parity")
    parity = phase_parity_bf16(cfg, state)
    log("== phase 12: the serving frontend on Llama-3-8B (open-loop mix, host KV tier, migration)")
    frontend = phase_serving_frontend(cfg, state, env["card"])
    log("== phase 13: the step set as CUDA graphs, and speculative decoding, on Llama-3-8B")
    graphs = phase_step_graphs(cfg, state, env["card"])
    log("== phase 14: the serving fleet on Llama-3-8B (3 replicas on one card, a kill and a recovery)")
    fleet = phase_fleet(cfg, state, env["card"])
    log("== phase 22: weight-only int8 serving of Llama-3-8B (K4b's bf16 store a layer at a time)")
    int8 = phase_int8_serving(cfg, state, env["card"], parity["plain_vs_f32"])
    del state
    gc.collect()            # the engines' cycles hold their weights and arenas
    torch.cuda.empty_cache()
    parity_f32 = phase_parity_f32()
    log("== phase 16: serving Falcon-7B at full width and depth (HF names through FalconPolicy)")
    falcon = phase_falcon_7b(env["card"])
    log(f"== phase 17: the zoo through build_hf_engine from a directory ({ZOO_LAYERS} layers of each)")
    zoo_keep = tempfile.mkdtemp(prefix="zoo_tp_")      # TP_ZOO's directories, served again in phase 27(a)
    atexit.register(shutil.rmtree, zoo_keep, ignore_errors=True)
    zoo = phase_zoo(env["card"], zoo_keep)
    log("== phase 18: serving Qwen1.5-MoE-A2.7B at full width and depth (HF names through Qwen2MoePolicy)")
    qwen_moe = phase_qwen_moe(env["card"])
    log(f"== phase 19: Mixtral-8x7B through build_hf_engine from a directory ({MIXTRAL_LAYERS} of 32 layers)")
    mixtral = phase_mixtral_dir(env["card"])
    log("== phase 21: the v1 engine on GPT-NeoX at pythia-6.9b's config (K1 through kernel injection); GPT-2 training")
    v1 = phase_v1_engine(env["card"])
    log(f"== phase 23: the v1 families through build_hf_engine from directories ({V1_ZOO_LAYERS} layers of each)")
    v1_zoo = phase_v1_zoo(env["card"])
    log("== phase 5: K1/K2a/K2b flash attention vs their plain versions")
    flash = phase_flash_kernels()
    log("== phase 6: training Llama-125M")
    training = phase_training(env["card"])
    log("== phase 7: training parity")
    phase_training_parity_f32()
    phase_training_parity_bf16()
    log("== phase 15: training features on Llama-125M (dataloader, checkpoints, optimizers, PLD, timers, monitor)")
    features = phase_training_features(env["card"], keep_step2=True)
    log(f"== phase 20: training Mixtral-8x7B's widths ({MOE_TRAIN_LAYERS} layer) with the router loss")
    moe_training = phase_moe_training(env["card"])
    log(f"== phase 24: training the dense zoo (Phi-2 at full depth; {ZOO_LAYERS} layers of seven more families)")
    zoo_training = phase_zoo_training(env["card"])
    log(f"== phase 26: offload (host Adam and the host-streamed tier on Phi-2 at {OFFLOAD_PHI2_LAYERS} layers; "
        "NVMe, parameters in host memory, offload_states and the universal checkpoint on Llama-125M)")
    offload = phase_offload(env["card"], features.pop("universal"))
    log("== phase 8: K6a/K6b/K6c block-sparse attention vs their plain versions")
    sparse = phase_sparse_kernels()
    log("== phase 9: the sparse path: DeepSpeedConfig -> SparseSelfAttention forward and backward")
    sparse_path = phase_sparse_path(env["card"])
    log("== phase 10: K4a/K4b/K5a/K5b quantization vs their plain versions")
    quant = phase_quant_kernels()
    log("== phase 11: data-parallel training on two ranks with the ZeRO++ quantized gradient wire (then phase "
        "27(a) on the same ranks)")
    phi2_ref = phi2_tp_reference()
    log(f"  phase 27(a)'s one-card Phi-2 reference: {phi2_ref['seconds']:.1f} s")
    tp_inputs = {"dirs": {name: zoo[name]["dir"] for name in TP_ZOO}, "v1": v1.pop("tp_reference")}
    dp = phase_data_parallel(env["card"], tp_inputs)
    log("== phase 27(a): tensor-parallel serving of Llama-3-8B, Qwen1.5-MoE-A2.7B, Phi-2, Falcon-RW-1B and OPT-6.7B, "
        "and the v1 engine on pythia-6.9b, over phase 11's 2 gloo ranks on the card")
    tp_serving, tp_checks, tp_k3 = phase_tensor_parallel_serving(env["card"], dp.pop("tp_ranks"),
                                                                 serving.pop("tp_reference"), parity_f32, parity)
    log("  tensor parallel serving: " + json.dumps(tp_serving))
    tp_qwen, qwen_checks, tp_qwen_k3 = phase_tensor_parallel_qwen(
        env["card"], dp.pop("tp_qwen_ranks"), qwen_moe["serving"].pop("tp_reference"),
        qwen_moe.pop("tp_f32_reference"), qwen_moe["parity"]["plain_vs_f32"])
    log("  tensor parallel serving of Qwen1.5-MoE-A2.7B: " + json.dumps(tp_qwen))
    tp_checks.update(qwen_checks)
    tp_k3 += tp_qwen_k3
    zoo_refs = {"phi-2": phi2_ref, "v1": tp_inputs["v1"], **{name: zoo[name].pop("tp_reference") for name in TP_ZOO}}
    tp_zoo, zoo_checks, tp_zoo_k3, tp_v1_k1 = phase_tensor_parallel_zoo(env["card"], dp.pop("tp_zoo_ranks"), zoo_refs,
                                                                        parity["plain_vs_f32"])
    log("  tensor parallel serving of Phi-2, Falcon-RW-1B, OPT-6.7B and the v1 engine: " + json.dumps(tp_zoo))
    tp_checks.update(zoo_checks)
    tp_k3 += tp_zoo_k3
    shutil.rmtree(zoo_keep, ignore_errors=True)
    bad = [k for k, ok in tp_checks.items() if not ok]
    if bad:
        raise AssertionError(f"tensor-parallel serving failed {bad}")
    log("== phase 25: ZeRO stages 0-2 over 3 ranks and 3 over 4 ranks on Llama-125M; Mixtral-8x7B's widths over "
        "data 2 x expert 2 and expert 2 x tensor 2 (gloo, one card)")
    zero = phase_zero(env["card"], moe_training["params"], training["first_rows_loss"])
    dec, ver = k3["decode"], k3["verify"]
    zoo_launches = sum(r["k3_launches"] for r in zoo.values())
    kernels = [{"name": "paged_attention", "route": "cuda", "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
                "replaces": "deepspeed_tpu/ops/paged_attention.py:40",
                "launches": serving["k3_launches"] + frontend["k3_launches"] + graphs["k3_launches"]
                + fleet["k3_launches"] + falcon["serving"]["k3_launches"] + zoo_launches
                + qwen_moe["serving"]["k3_launches"] + mixtral["k3_launches"] + int8["serving"]["k3_launches"]
                + tp_k3,
                # a partition of "launches": phase 13's are the verify
                # rounds of its spec serving run and the rest of the phase
                "launches_by_path": {"serving_step": serving["k3_launches"],
                                     "serving_frontend": frontend["k3_launches"],
                                     "step_graphs": graphs["k3_launches"] - graphs["verify_k3_launches"],
                                     "verify": graphs["verify_k3_launches"], "fleet": fleet["k3_launches"],
                                     "falcon_7b": falcon["serving"]["k3_launches"], "zoo": zoo_launches,
                                     "qwen_moe": qwen_moe["serving"]["k3_launches"],
                                     "mixtral": mixtral["k3_launches"], "int8_serving": int8["serving"]["k3_launches"],
                                     "tp_serving": tp_k3},
                "max_abs_err": max(r["max_abs_err"] for n, r in k3.items() if not n.endswith("_f32")), "ms": dec["ms"],
                "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
                "library_ms": dec["library_ms"], "prefill_ms": k3["prefill"]["ms"],
                "prefill_library_ms": k3["prefill"]["library_ms"], "verify_ms": ver["ms"],
                "verify_plain_ms": ver["plain_ms"], "verify_bound_ms": ver["bound_ms"],
                "verify_library_ms": ver["library_ms"],
                # phase 2's zoo rows (head dims 80/96, Falcon-7B's 71:1, window, alibi, Qwen1.5-MoE's 16:16)
                "zoo_rows": {n: {k: k3[n][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                        "max_abs_err", "n_split")}
                             for n in zoo_shapes(np.random.default_rng(30))},
                # phase 2's rows at a tensor-2 rank's heads: Llama-3-8B's 16:4 and Qwen1.5-MoE's 8:8
                "tp_rows": {n: {k: k3[n][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                      "max_abs_err", "n_split")}
                            for n in ("tp_16_4_decode", "tp_16_4_chunk", "tp_8_8_decode", "tp_8_8_chunk")
                            + tuple(f"{label}_{kind}" for label in tp_zoo_k3_heads() for kind in ("decode", "chunk"))}}]
    replaces = {"flash_fwd": "deepspeed_tpu/ops/flash_attention.py:162",
                "flash_dq": "deepspeed_tpu/ops/flash_attention.py:287",
                "flash_dkv": "deepspeed_tpu/ops/flash_attention.py:309"}
    for name, where in replaces.items():
        row = flash["bench"][name]     # the training path's shapes
        by_path = {"training": training["launches"][name], "training_features": features["launches"][name],
                   "moe_training": moe_training["launches"][name],
                   "gpt2_training": v1["gpt2_training"]["launches"][name],
                   "zoo_training": zoo_training["launches"][name], "zero_ranks": zero["launches"][f"{name}_cuda"],
                   "expert_parallel": zero["ep_launches"][f"{name}_cuda"],
                   "expert_x_tensor": zero["etp_launches"][f"{name}_cuda"],
                   "offload": offload["launches"][name], "tp_training": zero["tp_launches"][f"{name}_cuda"],
                   "zoo_tp_training": zero["zoo_tp_launches"][f"{name}_cuda"]}
        if name == "flash_fwd":
            by_path["v1_engine"] = v1["k1_launches"]
            by_path["v1_engine_tp"] = tp_v1_k1
        kernels.append({"name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/flash_attention.cu",
                        "replaces": where, "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": max(flash[s][name]["max_abs_err"] for s in flash), "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        # phase 5's zoo rows: head dims 80 and 96, Falcon-7B's 71:1 (bf16 and f32), and
                        # Phi-2's tensor-2 rank (16:16, D 80)
                        "zoo_rows": {s: {k: flash[s][name][k] for k in ("case", "ms", "plain_ms", "bound_ms",
                                                                        "bound_by", "library_ms", "max_abs_err")}
                                     for s in flash if s not in FLASH_SHAPES}})
    replaces = {"sparse_attn_fwd": "deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:35",
                "sparse_attn_dq": "deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:125",
                "sparse_attn_dkv": "deepspeed_tpu/ops/sparse_attention/pallas_kernel.py:152"}
    for name, where in replaces.items():
        row = sparse["timed"]["fixed"][name]     # the entry-point path's layout
        kernels.append({"name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/sparse_attention.cu",
                        "replaces": where, "launches": sparse_path["launches"][name],
                        "max_abs_err": sparse["errs"][name], "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # no single PyTorch call quantizes per block with an absmax scale: library_ms is null
    for name in QUANT_NAMES:
        row = quant["rows"][name]     # the embedding's shape, the wire's largest tensor
        launches = dp["launches"] if "int8" in name else dp["int4_launches"]
        total = launches[f"{name}_cuda"] + (int8["k4b_launches"] if name == "dequantize_int8" else 0)
        entry = {"name": name, "route": "cuda", "source": "deepspeed_tpu_torch/csrc/quant.cu",
                 "replaces": QUANT_REPLACES[name], "launches": total,
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None}
        if "int8" in name:   # the grouped launches of one qgZ step (phase 10's step table)
            entry.update(launches_per_step=launches[f"{name}_cuda"] / (DP_WARMUP + DP_TIMED),
                         step_ms=quant["step"]["step_ms"][name], step_bound_ms=quant["step"]["step_bound_ms"][name])
        if name == "dequantize_int8":   # the int8 weights of phase 22: block 128, the bf16 store
            k4b = int8["k4b_bf16"]["embed_tokens.weight"]
            entry.update(launches_by_path={"data_parallel": launches[f"{name}_cuda"],
                                           "int8_serving": int8["k4b_launches"]},
                         block128_bf16={k: k4b[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")})
        if name == "quantize_int4":   # its launches by kernel, and its bf16 and misaligned-view times
            entry.update(routes=dp["int4_routes"], bf16_ms=row["bf16_ms"], bf16_plain_ms=row["bf16_plain_ms"],
                         bf16_bound_ms=row["bf16_bound_ms"], misaligned_ms=row["misaligned_ms"])
        kernels.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
