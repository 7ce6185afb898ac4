#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

1. env      — torch / CUDA versions, the card, ``nvidia-smi`` name and
              power limit, the idle card's power draw (5 readings before
              any work); TF32 switched off for matmuls and cuDNN.
2. build    — ``nvcc`` builds every kernel library from the sources in
              the checkout (one process per source, all at once).
3. kernels  — each kernel against its plain PyTorch version on the card
              at the serving path's shapes (B=4, H=40, K=10, hd=128,
              bs=16, n_blk=32; S=4 new tokens for the extend read):
              bf16 / f32 pages and int8 pages with scales under f32
              and under bf16 queries (the pair int8 serving runs),
              softcap 0 and 50 (at scale 1, where it binds), ragged
              lengths, -1 table entries, an empty row (decode) and a
              row at pos 0 (extend); granite-moe-1b-a400m's served
              decode shape (H=16, K=8, hd=64, 128-page tables; bf16 and
              int8 pages, each timed) and its int8 catch-up widths
              (S = 16 and 64, held and timed); lengths and pos on the
              split plan's boundaries, one page short of them and with a -1 hole
              that empties a split, two calls bitwise equal, and a
              plain merge without the last split's partial shown to
              fall outside the tolerance; gemma3-1b's global-layer shape
              (H=4, K=1, hd=256) and the shapes gemma's serving gives
              them (128-page tables; 16-token int8 catch-up waves); the
              extend read on int8 pages at every width class a catch-up
              wave may have (gemma3-1b S = 16, 21, 22, 64, 512; phi3
              S = 41, 64: the first version refused S >= 22 and 41
              there) and at G x S one and four rows past a 64-row tile,
              each with its plan's merge without the last split shown
              to fail; the
              paged reads at internvl2-76b's shape (64 query heads over
              8 kv heads of 128: G = 8) and whisper-base's (8 heads of
              64: G = 1), 64-page tables, bf16 and int8 pages (the
              decode read) and int8 catch-up and verify widths (the
              extend read: S = 5 and 16; 16), each held, its plan's
              merge without the last split shown to fail, and timed; the
              decode read timed at the serving shape, at 4 rows x 4096
              tokens (8 pools, 670 MB), at the gemma shape and at its
              served shape, beside SDPA with the gather timed and
              without; the extend read timed at the serving shape and at
              gemma's served chunk of 16 and at 64 and 512; both reads'
              bf16 ptxas lines.
              ``quant_matmul`` at the draft's decode shapes (M=4
              against every projection of a phi3-medium-14b layer), a
              ragged one and one whose K is too short to split; its
              M > 8 kernel at M = 9, 16, 64, 300 and 2048 against every
              projection, a ragged K, weight rows that are not 16-byte
              vectors and x rows that are not; x in bf16 and f32, with
              three broken versions shown to fall far outside the
              tolerance; two calls of each kernel bitwise equal at split
              and unsplit plans; every decode shape and M = 512 and 2048
              of every projection timed on cold weights beside its bound
              and the bf16 cuBLAS yardstick (the plans printed), the sum
              over one draft layer's seven decode launches and over a
              draft prefill's 56; the int8 draft's projections of
              internvl2-76b (K = 8192 and 28672) at M = 4, 9, 64 and
              768, x in bf16 and f32, two broken versions at K = 28672,
              M = 4 and 768 timed; the ptxas lines of the M > 8 kernel;
              ``ssd_scan`` against the plain chunked path in float32 at
              mamba2-370m's width (h=32, p=64, n=128, chunk 256) for b 1
              and 4, l 16 / 256 / 300 / 1024 / 2048, at zamba2-7b's
              (112 heads, p 64, n 64) and at 30 heads, x in bf16 and
              f32, a split sequence continued through ``h0``, and three
              broken versions (state dropped between chunks, decay left
              out, the state passed without its decay); timed at 4 x
              1024, 1 x 1024 and 4 x 2048, and at zamba2-7b's width at
              4 x 1024, beside its bound at the bf16 tensor-core and the
              float32 rates; its bf16 ptxas lines.
              ``flash_attention`` at the evaluation path's shape (B=2,
              S=T=4096, H=4, K=1, hd=256) with window 0 and 512, phi3's
              GQA (H=40, K=10, hd=128, S=512), a ragged S=300, T < S and
              T > S, zamba2-7b's prefill (B=4, S=T=1024, 32 heads over
              32 of hd 112, in the 128-wide instantiation; also timed
              beside its bound and SDPA), bf16 and f32, a softcap of 50
              that binds, two broken
              versions (window ignored, causal mask one key late), and
              the window-512 launch under half the global one's time;
              the ptxas lines of its bf16 tensor-core kernel.
              Times the kernel, the plain version and a PyTorch library
              call (none for the scan), next to the bound.
4. serve    — the first main path: phi3-medium-14b at full width and
              depth (bf16 weights from a seeded generator, ~29 GB)
              behind ``EdgeServingEngine`` with ``use_pallas_paged=True``
              on a bf16 pool; 8 greedy requests of 16-300 prompt tokens
              x 32 new tokens through the CLI's drain loop.  Kernel
              launch counts are zeroed just before and read just after:
              every layer of every decode wave must have gone through
              ``paged_attention``, and nothing through the extend kernel
              (a float pool keeps the gather, as in JAX).
5. model    — from one cache state, ``decode_step_paged`` through the
              kernel and through the gather: logits must agree within
              the stated tolerances; times one decode wave of each.
6. serve_int8 — the second main path: the same model and traffic with
              ``quant_kv="int8"`` (the first engine's weights): every
              decode wave's layers through ``paged_attention`` on int8
              pages, every catch-up extend wave's layers through
              ``paged_extend_attention``.
7. model_int8 — on the int8 pool at float32 activations, kernel reads
              against gather reads for decode and for extend: each
              layer's block on identical inputs within the float32
              kernel tolerance, greedy tokens of the two full-model runs
              equal (their logits and the written bytes that differ are
              reported); times one extend and one decode wave of each
              read at bf16.
8. serve_dense — the dense twin (``ServeConfig(paged=False)``): the same
              model, weights and traffic as ``serve`` on ``max_len``
              strips per slot (no pool, no prefix cache): every request
              finishes, no kernel launches (as in JAX), and the tokens
              meet the int8 gate against ``serve``'s.
9. serve_shared — the eighth main path: the same model, its first
              SHARED_DEPTH = 20 of 40 layers (the one depth cut of an
              earlier path, for the script's time), at
              ``ServeConfig``'s defaults (the radix prefix cache on),
              ``use_pallas_paged=True``, max_len 512, on a bf16 and on an
              int8 pool; 8 household users on one 205-token system prompt
              (12 pages and 13 tokens), 5 shared persona tokens, 8-200
              own tokens, 32 new each; user 0 alone to its first token,
              then users 1-7.  7 hits and 1 miss, hits past the page
              boundary with a copy-on-write fork, ``paged_attention`` ==
              20 x decode waves (and ``paged_extend_attention`` == 20 x
              extend waves on int8 pages), no page leaked, the hit rows'
              tokens held by the int8 gate to a cold engine's (on int8
              pages: first tokens equal, and they drift from the cold
              rows no faster than int8 pages alone move the cold rows
              off the bf16 pool's); decode waves and the decode read on
              shared and on private pages timed; the bf16 leg writes its
              cache to a store, a fresh engine reads it back and
              re-serves user 1 as a hit with the live re-serve's tokens.
10. serve_spec — the third main path: the same model and traffic served
              speculatively on an int8 pool (``spec_decode``,
              ``spec_gamma=4``, ``quant_draft``) with an explicit draft:
              the verify model's first 8 layers (copied) under an
              early-exit norm, quantized to int8 by the engine.  Every
              wave is a verify extend wave through
              ``paged_extend_attention`` (40 launches each), no wave
              decodes through ``paged_attention``, and every draft
              forward call (decode steps and admission prefills, counted
              here around ``SpecDecoder``) runs its 7 x 8 projections
              through ``quant_matmul``.  Times one draft step with int8
              and with bf16 weights, and one int8 draft admission
              prefill of 4 rows x bucket 512 (56 launches at M = 2048).
11. serve_traced — phi3 again on ``serve``'s weights, ServeConfig and
              traffic with ``trace=True`` (the span tracer): tokens and
              ``paged_attention`` launches equal ``serve``'s, the Chrome
              trace validates, every request's TTFT decomposes exactly
              (queue wait + prefill + first wave); per span (dispatch,
              sync, retire, admit, plan, prefill_dispatch, prefill_sync,
              publish) calls, mean and total ms and ms per step, and per
              wave kind the step's dispatch / sync / retire split (the
              host/device split of a step: ``sync`` waits for the device
              after the host has issued the wave).  Then the same drive
              untraced: the trace's overhead in ms per step, beside the
              tracer's own host cost per span and event.
12. serve_ssm — the fourth main path: mamba2-370m at full width and
              depth (bf16, ~0.74 GB) behind the engine's pool-free path
              (no page pool: ``eng.paged`` False) with
              ``use_pallas_paged=True``, prefill buckets up to 1024, 8
              greedy requests of 16-1000 prompt tokens x 32 new tokens:
              every layer of every admission prefill (calls counted
              around ``_admit_group``) scans through ``ssd_scan``, and no
              paged or quant kernel launches.  Profiles one decode wave.
13. model_ssm — one 4-row bucket-1024 ``ssm.prefill`` with ragged
              ``true_len`` through the kernel and through the plain
              chunked path at float32: logits and final states within
              the stated share of their max, greedy tokens equal; one
              bf16 prefill of each timed.
14. train    — the fifth main path: gemma3-1b at full width and depth
              (26 layers, float32 weights from a seeded generator, ~1.0e9
              parameters) trained 3 steps through ``launch.train``'s
              flags, state and step, which is ``specs.build_train``'s on
              the one-card mesh (``mesh.make_local_mesh``: NCCL, world
              size 1; one device, so plain tensors): 4 x 4096 bigram
              tokens a step in 2
              micro-batches, remat ``nothing_saveable``, float32 AdamW
              moments; ms and tokens/s per step, peak memory, one step's
              device idle share; one extra ``trainer.make_train_step``
              step from the same state and first batch with loss, grad
              norm and new state bit for bit the built step's, and its
              ms; losses finite; no kernel launches (the plain attention
              runs under autograd).
15. model_train — on the trained weights, ``loss_fn(use_flash=True)``
              against ``loss_fn(use_flash=False)`` on 2 x 4096 tokens:
              at float32 the CE within 1e-5 relative and the logits
              within 1e-4 x max |logit|; at bf16 every layer's
              ``attention_fwd`` through the kernel and the plain path on
              identical inputs within 2**-6 x max |o|; ``flash_attention``
              launches == 26 x forwards through it; one bf16 loss
              forward each way timed.
16. serve_gemma — the sixth main path: gemma3-1b at full width and
              depth (26 layers: 4 super-blocks of 5 local + 1 global and
              2 remainder local layers, bf16 weights from a seeded
              generator, ~2 GB) through ``launch.serve.build_engine`` on
              a bf16 pool: local layers on dense rings of 512 per slot,
              global layers on the pages; buckets to 512, catch-up chunk
              16, 8 greedy requests of 16-1000 prompt tokens x 32 new
              tokens, at least one past the largest bucket and the window
              (its catch-up extend waves wrap the rings).  Every global
              layer of every decode wave reads through
              ``paged_attention`` (4 x decode waves), nothing through the
              extend kernel.  Times and profiles one decode wave.
17. serve_gemma_int8 — the same model and traffic on an int8 pool (the
              rings stay bf16): ``paged_attention`` == 4 x decode waves,
              ``paged_extend_attention`` == 4 x extend waves.
18. serve_gemma_wide — the gemma3-1b weights on an int8 pool with
              catch-up chunk 64, 4 greedy requests of 600-1000 prompt
              tokens x 8 new: every extend call at S = 64 through
              ``paged_extend_attention`` (4 x extend waves), held against
              the same engine reading through the gather by the int8
              gate.
19. serve_async — the serve CLI's default path: gemma3-1b on
              ``serve_gemma``'s weights and ServeConfig, traced, through
              ``launch.serve.AsyncServingFrontend`` (steps on the loop's
              executor thread).  Leg 1: all 8 requests submitted before
              the first step, tokens equal ``serve_gemma``'s.  Leg 2: a
              fresh engine, arrivals 20 ms apart, request 1 cancelled
              after its first streamed token: every stream equals its
              request's tokens, the cancelled one is marked so, no page
              leaks, the trace holds ``cancel_applied``; ``slo_stats()``
              and the span phases.  Each leg: ``paged_attention`` == 4 x
              decode waves.  Then ``launch.serve.main`` at its defaults
              (``--mode async``, smoke scale, on the card) with
              ``--trace``: its JSON line, a valid trace, launches == the
              smoke model's global layers x the trace's decode waves.
              Every await has a time limit.
20. serve_hybrid — the seventh main path: zamba2-7b at full width and
              depth (81 layers: 13 super-blocks of 5 mamba blocks and
              the shared attention block, 3 remainder mamba blocks;
              bf16, ~11.2 GB) through ``launch.serve.build_engine``
              behind the pool-free engine (rings of min(max_len,
              4096) = 2048 per slot and application), buckets to 1024,
              8 greedy requests of 16-1000 prompt tokens x 32 new: each
              admission prefill scans 68 mamba blocks through
              ``ssd_scan`` and runs the 13 shared-block applications
              through ``flash_attention``; no paged or quant kernel
              launches.  Profiles one decode wave.
21. model_hybrid — one 4-row bucket-1024 hybrid prefill with ragged
              ``true_len`` through the kernels and through the plain
              path at float32: logits, mamba states and ring K/V within
              the stated share of their max, greedy tokens equal; one
              bf16 prefill of each timed.
22. serve_moe — the ninth main path: granite-moe-1b-a400m at full width
              and depth (24 layers of 32 experts, top 8, expert d_ff
              512, 16 heads over 8 kv heads of 64; bf16, ~2.67 GB)
              through ``launch.serve.build_engine`` on a bf16 pool at
              ``serve_gemma``'s settings and traffic (4 slots, max_len
              2048, buckets to 512, catch-up chunk 16, 8 requests of
              16-1000 prompt tokens x 32 new): ``paged_attention`` ==
              24 x decode waves, nothing through the extend kernel.
              Times and profiles one 4-slot decode wave beside its bound
              (every expert's weights and the wave's pages).  Then
              ``launch.serve.main`` at its defaults for granite at full
              size: its line, and decode reads through the kernel.
23. serve_moe_int8 — the same weights and traffic on an int8 pool:
              ``paged_attention`` == 24 x decode waves,
              ``paged_extend_attention`` == 24 x extend waves; every
              layer's kernel read against the gather read on identical
              inputs (``_layerwise_blocks`` over ``model.paged_layers``)
              for a decode and a 16-token extend wave; tokens reported
              against ``serve_moe``'s by the int8 gate.
24. serve_moe_shared — granite at ``ServeConfig``'s defaults, max_len
              512, the hand-written reads, ``serve_shared``'s household
              traffic: 7 hits and 1470 hit tokens, ``paged_attention``
              == 24 x decode waves, no page leaked; hit rows' tokens
              reported against a cold engine (capacity follows the
              suffix's shape, so they may differ).
25. model_moe — on ``serve_moe``'s pool: one 4-slot decode wave through
              the kernel and the gather read (greedy tokens equal,
              logits within BF16_REL_TOL of max |logit|); the first moe
              layer's routing on the card against the CPU in float32 on
              its normed input of a 4 x 512 batch (experts, positions and
              kept pairs equal but at counted near-ties, outputs of rows
              routed alike within the float32 tolerance); the share of
              real (token, choice) pairs dropped at a decode wave
              (capacity 2), a 16-token catch-up wave (20) and the
              4 x 512 prefill (640).
26. serve_vlm — the tenth main path: internvl2-76b at full width
              (d_model 8192, 64 query heads over 8 kv heads of 128,
              d_ff 28672, vocab 128256, 256 image tokens of 3200) and 32
              of its 80 layers (the one cut: 29.57e9 bf16 parameters,
              59.1 GB) behind ``EdgeServingEngine`` on a bf16 pool, 4
              slots, max_len 1024, buckets to 512, chunked prefill with
              16-token chunks; 8 requests of 16-400 text tokens, each
              with its own 256 x 3200 image, 32 new: ``paged_attention``
              == 32 x decode waves; one decode wave timed and profiled
              beside its bound (the trunk's and head's weights).
27. model_vlm — ``model``'s kernel-vs-gather decode wave on that pool.
28. serve_vlm_int8 — the same on an int8 pool: catch-up waves through
              ``paged_extend_attention`` (32 x extend waves), every
              layer's kernel read held to the gather read on identical
              inputs for a decode and a 16-token extend wave.
29. serve_vlm_shared — internvl2 at ``ServeConfig``'s other defaults
              (the prefix cache on), max_len 1024, buckets to 512, on
              ``serve_shared``'s household traffic with one image for
              users 0-7 and a ninth user with another image and user
              1's text: predicted 7 hits of 256 + 210 tokens (every hit
              covers the image), 2 misses (the ninth user never hits),
              each request's acquired context recorded; no page leaked;
              hit rows' first tokens equal a cold engine's (the tokens
              after them reported).
30. serve_vlm_spec — internvl2 speculating on an int8 pool with a
              2-layer int8 draft (``make_draft``) that prefills its own
              image: extend launches == 32 x waves, ``quant_matmul`` ==
              7 x 2 x draft forward calls at K = 8192 and 28672.
31. serve_whisper — whisper-base at full size (6 + 6 layers of 512,
              1500 audio frames) through ``launch.serve.build_engine``
              on a bf16 and an int8 pool, max_len 448, buckets to 128,
              8 requests of 16-300 tokens with their own 1500 x 512
              audio (decode reads through the kernel, 6 a wave; int8
              catch-up through the extend kernel), then the serve CLI at
              its defaults (``--mode async``, prefix cache on).
32. model_whisper — the kernel-vs-gather decode wave on its pool.
33. reference_vlm / 34. reference_encdec — the internvl2 and whisper
              smoke configs at float32 with their extras, prompts past
              the largest bucket: card tokens equal the CPU's on a float
              pool and meet the int8 gate on an int8 pool.
35. reference_moe — the granite and kimi-k2 smoke configs at float32 and
              capacity factor 1.25 (pairs drop), traffic whose slots go
              idle mid-run and whose long prompts catch up: card tokens
              equal the CPU's on a float pool and meet the int8 gate on
              an int8 pool, both kernels launched.
36. reference_gemma — the gemma3-1b smoke config at float32 (window
              16), prompts of 20-150 tokens: the engine on the card and on
              the CPU emit the same greedy tokens on a float pool and
              meet the int8 gate on an int8 pool, both kernels launched.
37. reference — the phi3 smoke config at float32: the engine on the card
              (hand kernels) and on the CPU (plain versions) must emit
              the same greedy tokens on a float pool, and on an int8
              pool meet the JAX package's int8 gate (every first token
              equal, longest common prefix >= 60% of the tokens); the
              speculative engine with an int8 draft on the card (the
              verify model's first layer of 2) must emit the CPU vanilla
              engine's tokens exactly on the float pool and meet the
              int8 gate on the int8 pool; the mamba2 smoke config behind
              the pool-free engine, with prompts past the largest
              bucket, must emit the CPU's tokens on the card, and so
              must the zamba2 smoke config (window 16: rings wrap),
              with ``ssd_scan`` and ``flash_attention`` launched; the
              gemma3-1b smoke config (8 layers) at float32: the card's
              ``loss_fn(use_flash=True)`` within 1e-5 of the CPU's, two
              train steps' losses and gradient norms within 1e-4.
38. reference_shared — the phi3 smoke config at float32 over
              ``tests/test_engine_matrix.py``'s traffic (copied): the dense
              twin, the prefix-cache engine with the hand-written reads
              and the same speculating on the card, and the prefix-cache
              engine on the CPU, emit exactly the same greedy tokens; the
              prefix-cache engine on an int8 pool on the card meets the
              JAX matrix's int8 gate against them.

The hub's phases (the EdgeAI-Hub core and the federated round), in
the order they run among the above:

39. split   — after ``serve_traced``, on its phi3-medium-14b weights:
              ``choose_split`` for each non-hub device of
              ``default_home()`` at 4 x 256 tokens (printed), then
              ``split_forward`` at each distinct chosen cut, the middle
              cut 20 and the ends 0 and 40 on 4 x 256 seeded tokens: the
              ends equal ``T.forward`` within 2**-8 x max |logit|, the
              middle cuts within the JAX test's 0.05 x (max + 1) at 8
              bits and 4 bits further off, the payload ``wire_bytes``;
              head, wire and tail device ms at the middle cut.  No kernel
              launches (the plain attention, as in JAX).
40. early_exit — the same weights with exit heads after layers 9, 19
              and 29: ``serve_early_exit`` at threshold 0.0 runs 10
              layers (0.75 of the FLOPs saved) and at 1.1 all 40, the
              last entry of ``forward_with_exits`` equals ``T.forward``,
              ``exit_loss`` finite; wall ms of the eager pass against the
              pass that never exits.
41. federated — after ``model_train``: gemma3-1b at full size, float32
              weights from seed 0, through ``EdgeAIHub.federated_round``
              on alice's personal data: 4 clients offered, 2 kept by the
              trust zones, 2 local SGD steps each on 2 x 2 x 256 tokens,
              clip 1.0, DP noise 0.01, SecAgg; the same round without
              noise equals the unmasked round within 1e-6, every clipped
              delta's norm <= 1, the noise's std sigma within 1%; the
              held-out CE before and after through ``flash_attention``
              (26 launches a forward); local step ms, round s, peak GB.
42. hub     — after ``serve_async``: ``EdgeAIHub.create(policy="edf")``
              deploys ``serve_gemma``'s weights and serves its traffic
              through ``hub.serve`` (tokens equal ``serve_gemma``'s,
              ``paged_attention`` == 4 x decode waves), then the
              federated round's params cast to bf16 on an int8 pool
              (both paged reads); the orchestrator's days of
              ``tests/test_system.py`` and ``examples/edge_hub_serving.py``
              with the vacuum failing (QoE reports); the shared-context
              space trained 150 SGD steps on the card, fused accuracy
              above each single view's.
43. reference_hub — last: the phi3 smoke config's ``split_forward`` and
              ``serve_early_exit``, the gemma3-1b smoke config's
              ``fed_round`` (no noise), the context logits, card against
              CPU at float32; the day's report equal to ``hub``'s.

The long-sequence phases (the blockwise branch of ``attention_fwd`` and
the remat policies), in the order they run among the above:

44. long_attention — after ``kernels``, on an empty card: one global
              attention layer of gemma3-1b (4 heads over 1 of 256) and of
              phi3-medium-14b (40 over 10 of 128) at S = 8192, and
              gemma's at 32768, bf16, B = 1: ``attention_fwd`` walks the
              blockwise branch and agrees with ``use_flash=True``; the
              core through ``_blockwise_causal_attention``,
              ``flash_attention`` and the plain masked softmax (where
              2.5 of its float32 score tensors fit) on the same q, k, v
              within 2**-6 x max |out| of the kernel; a walk without the
              rescale shown to fail; device ms, peak GB above the inputs
              and the causal bound of each.
45. long_prefill — the eleventh main path, after ``early_exit`` on its
              phi3-medium-14b weights: one 8192-token prompt through the
              paged engine with buckets (16, 32, 64, 128, 8192), 32
              greedy tokens, ``use_pallas_paged``: the admission prefill
              walks the blockwise branch, ``paged_attention`` launches ==
              40 x decode waves at contexts to 8224, the first token is
              ``model.apply(use_flash=True)``'s last-row argmax (margin
              printed); TTFT and ms a decode step.  gemma3-1b's
              ``model.prefill`` at 32768 tokens through the blockwise
              branch against the use_flash route (float32 last logits
              within 1e-4 x max |logit|; bf16 times); prefill_32k's batch
              of 32 reckoned against the card.  The ``kernels`` phase
              holds and times ``paged_attention`` at the 8224 context.
46. train_remat — after ``model_train``, from the train phase's state:
              one gemma3-1b step at S = 8192, B = 1 under each policy
              (``nothing_saveable``, ``full``,
              ``dots_with_no_batch_dims_saveable``, ``dots_saveable``,
              then ``none`` and ``everything_saveable`` at 8192 where the
              reckoning fits, else at 4096 beside ``full``): loss, grad
              norm, step ms, peak GB; losses at one length equal.
47. launch_serve — after ``long_prefill``, on its phi3-medium-14b
              weights and the one-card mesh: ``specs.build_prefill`` at
              2 x 4096 and ``specs.build_serve``'s decode step at 4 rows
              of a 4096 cache (position 1024), each against
              ``model.prefill`` / ``model.decode_step`` called directly:
              logits, cache and greedy tokens bit for bit equal; device
              ms and peak GB each way; the decode step's wall ms each way
              and on DTensors over the same mesh (DTensor's host cost;
              logits bit for bit), interleaved; and ``roofline.analyze``
              of each built step's own ``hlo_analysis.Trace`` beside its
              device ms.  No kernel launches.
48. launch   — after ``train_remat``, on its state: the
              ``SEQ_PARALLEL_ATTN`` knob set by hand to 2 and 4 shards on
              gemma3-1b's first global layer at S = 8192 against the
              unset walk (bit for bit, else within 2**-6 x max |out|;
              the shard offsets recorded), the roofline of the built
              train step from its own trace beside the train phase's
              device ms, the built step against the same step on
              DTensors over the mesh (loss and grad norm bit for bit,
              wall ms each way, interleaved), and phi3-medium-14b's
              param specs on the (16,
              16) production mesh against ``LAUNCH_GOLDEN_SPECS`` with a
              rule table that moves wq's first candidate shown to miss
              them.
49. dryrun   — after ``reference_hub``, on this machine's torch and
              not on the card: ``python -m repro_torch.launch.dryrun``
              for the routes DTensor's rules refuse unless the model
              layer lays them out itself (``DRYRUN_PAIRS``: whisper-base
              ``train_4k`` on the multi-pod mesh; gemma3-27b
              ``decode_32k``, mamba2-370m ``prefill_32k``, and the moe
              router and ring fill some torch versions have no rule
              for, granite-moe-1b-a400m ``train_4k`` and gemma3-1b
              ``prefill_32k``, on the pod mesh), one subprocess each
              (each brings up a fake world of 256 / 512 ranks, and the
              launch phases' NCCL group cannot be replaced in this
              process), and ``tests/test_torch_sharded.py traces`` for
              ``DRYRUN_TRACES`` (the moe layer's and the ring fill's
              smoke-size steps on three-axis meshes, under
              ``FakeTensorMode`` on a fake world of four), all at once:
              each record's status, per-chip dot FLOPs and collective
              bytes, the traces that passed, and the wall seconds; it
              fails unless every record and trace is ``ok``.

Before the last line it prints the kernels JSON object and the
``nvidia-smi`` line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "phi3-medium-14b"
SERVE = dict(max_slots=4, max_len=512, policy="priority")
N_REQ, MAX_NEW, MIN_PROMPT, MAX_PROMPT = 8, 32, 16, 300
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
# cuda_ms holds the stream with a spin of this many cycles a second
# (the H100's top SM clock is 1.98 GHz: a spin lasts at least as long)
SLEEP_CYCLES_PER_S = 2.0e9
SLEEP_MAX_MS = 3000.0
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# kernel vs its plain version computed in float32 on the same inputs,
# per case (CASES): float32 / int8 (float32 q) are the same float32 math
# summed in another order; a bfloat16 output is that float32 result
# rounded once to bfloat16, so it lies within one bfloat16 step (2**-8);
# flash_attention's plain version runs in float64 (an exact result
# rounded to bfloat16 can miss a float32 one by more, in near-tie rows)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "int8": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2 ** -8, atol=1e-5)}
# the cases each kernel is held on: (name, page dtype, query dtype,
# tolerance); bfloat16 queries over int8 pages give a bfloat16 output,
# the pair that int8 serving runs on the card
CASES = (("bfloat16", "bfloat16", "bfloat16", "bfloat16"),
         ("float32", "float32", "float32", "float32"),
         ("int8", "int8", "float32", "int8"),
         ("int8/bf16q", "int8", "bfloat16", "bfloat16"))
# softcap 50 is checked at scale 1, where scores reach tens and the cap
# binds: it must move the output by more than this, far past every TOL
CAP_MOVES = 0.1
# quant_matmul against its plain version, both fed x already rounded to
# bfloat16 (the kernel rounds x, the plain version does not), so only the
# summation order differs: float32 outputs of order 1 over K <= 17920
# within 1e-4; a bfloat16 output within one bfloat16 step (2**-8) of the
# float32 result
QM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
          "bfloat16": dict(rtol=2 ** -8, atol=1e-4)}
# a broken kernel must land this far from the plain version, far past
# QM_TOL: the scale applied along K instead of N, K cut short by one
# 32-row tile, or (M > 8) by one 64-row K step
QM_BROKEN_MOVES = 0.1
# phi3-medium-14b's projections (K, N), d=5120, K/V 10 x 128, d_ff 17920
QM_DECODE = {"wq / wo": (5120, 5120), "wk / wv": (5120, 1280),
             "w_gate / w_up": (5120, 17920), "w_down": (17920, 5120)}
QM_UNSPLIT = (4, 64, 1280)                    # K too short to split
# the M > 8 kernel: a draft admission prefill runs up to 4 prompts padded
# to a power-of-two bucket, M = rows x bucket; checked at these M against
# every projection, timed at QM_TIMED_M
QM_PREFILL_M = (9, 16, 64, 300, 2048)
QM_TIMED_M = (512, 2048)
# and at edges the projections do not reach: K not a multiple of the
# 64-row step, weight rows not 16-byte vectors (N % 16 != 0: masked
# scalar loads), x rows not 16-byte vectors (K % 8 != 0)
QM_EDGES = {"ragged K": (300, 5000, 1280), "N % 16 != 0": (40, 200, 72),
            "K % 8 != 0": (130, 100, 1280)}
DRAFT_BUCKET = 512                            # the timed draft prefill
# one draft layer's decode launches: wq, wk, wv, wo, w_gate, w_up, w_down
QM_LAYER_LAUNCHES = {"wq / wo": 2, "wk / wv": 2, "w_gate / w_up": 2,
                     "w_down": 1}
QM_COLD_BYTES = 128e6                         # > 2.5x the 50 MB L2
DRAFT_LAYERS = 8
# the fourth main path: mamba2-370m behind the pool-free engine; prompts
# of 513-1000 tokens walk 4 chunks of the scan in one admission prefill
SSM_ARCH = "mamba2-370m"
SSM_SERVE = dict(max_slots=4, max_len=2048, policy="priority",
                 prefill_buckets=(16, 32, 64, 128, 256, 512, 1024))
SSM_TRAFFIC = (8, 16, 1000, 32)               # requests, prompts, new
# ssd_scan at mamba2-370m's width and the model's chunk (cfg.ssm_chunk),
# and at the hybrid slice's zamba2-7b (112 heads of 64, state 64)
SSD_H, SSD_P, SSD_N, SSD_CHUNK = 32, 64, 128, 256
SSD_ZAMBA = (112, 64, 64)
# (b, l) checked at mamba2-370m's width, and the timed ones (the served
# 4 x 1024 prefill first: the kernels line's row)
SSD_CASES = ((1, 16), (1, 256), (1, 300), (1, 1024), (1, 2048), (4, 16),
             (4, 256), (4, 300), (4, 1024), (4, 2048))
SSD_TIMED = ((4, 1024), (1, 1024), (4, 2048))
# and timed at zamba2-7b's width on its served prefill (b, l)
SSD_ZAMBA_TIMED = (4, 1024)
# the kernel against the plain chunked path, both float32 on the same
# inputs: the same sums in another order (and exp of cumsum differences
# taken from another cumsum order), of order 1e-6 x max |y|; allowed
# 1e-4 x max |y|.  A bfloat16 y is that result rounded once: one
# bfloat16 step (2**-8 of the value) on top
SSD_F32_REL = 1e-4
SSD_BF16_STEP = 2 ** -8
SSD_BROKEN_MOVES = 0.1
# flash_attention at the evaluation path's shape (gemma3-1b: 4 query
# heads over 1 kv head, hd 256, window 512 on local layers) and beside it
FLASH_PATH = (2, 4096, 4096, 4, 1, 256)       # B, S, T, H, K, hd
FLASH_WINDOW = 512
FLASH_CASES = (                               # name, B, S, T, H, K, hd, window
    ("path global", *FLASH_PATH, 0), ("path local", *FLASH_PATH, FLASH_WINDOW),
    ("phi3 gqa", 2, 512, 512, 40, 10, 128, 0),
    ("ragged S=300", 2, 300, 300, 4, 1, 256, 64),
    ("T=200 < S=300", 2, 300, 200, 8, 2, 128, 0),
    ("T=190 > S=130", 1, 130, 190, 4, 4, 64, 16),
    ("zamba2 mha hd112", 4, 1024, 1024, 32, 32, 112, 0))
# zamba2-7b's admission prefill (a full bucket of 4 rows x 1024, 32 heads
# over 32 kv heads of 112, causal): a case above and a timed row
FLASH_HYBRID = (4, 1024, 1024, 32, 32, 112)   # B, S, T, H, K, hd
# the window-512 launch must take less than this share of the global
# one's time: its band holds 0.23 of the global launch's pairs
FLASH_BAND_SHARE = 0.5
# the fifth path: gemma3-1b trained through ``launch.train``'s step, then
# its loss scored through the kernel; 4 x 4096 tokens a step in two
# micro-batches of 2 x 4096 (the micro-batch's float32 log-softmax over
# 262144 classes is 8.6 GB, its gradient as much again, beside 16 GB of
# float32 weights, gradients and AdamW moments)
TRAIN_ARCH = "gemma3-1b"
TRAIN_ARGV = ("--arch", TRAIN_ARCH, "--scale", "full", "--batch", "4",
              "--seq", "4096", "--microbatches", "2", "--moments",
              "float32", "--steps", "3")
EVAL_ROWS, EVAL_SEQ = 2, 4096               # the scoring batch
# loss_fn through the kernel against the plain path at float32
# activations (TF32 off): the same float32 math summed in another order
CE_F32_REL = 1e-5
LOGIT_F32_REL = 1e-4
# each layer's attention output at bf16 on identical inputs, as a share
# of its max |o|: the plain path rounds every softmax probability to
# bf16 before the p.v product (2**-9 relative each) and both round the
# (B, S, H, hd) attention output to bf16 before the bf16 wo product
# (2**-9 each, and that product rounds again); four bf16 steps (2**-6)
# cover the three roundings with room, while a wrong mask or window
# moves an output by a large share of its size
LAYER_BF16_REL = 2 ** -6
SPEC = dict(spec_decode=True, spec_gamma=4, quant_draft=True)
# the sixth path: gemma3-1b served, its 20 local layers on dense rings of
# W = 512 per slot beside 4 global layers on the page pool; prompts past
# the largest bucket (512 = W) catch up in 16-token extend waves, so the
# rings wrap
GEMMA_ARCH = "gemma3-1b"
GEMMA_SERVE = dict(max_slots=4, max_len=2048, policy="priority",
                   prefill_buckets=(16, 32, 64, 128, 256, 512),
                   catch_chunk=16)
GEMMA_TRAFFIC = (8, 16, 1000, 32)             # requests, prompts, new
# kernel vs gather read of the whole 40-layer model, as a share of
# max |logit|: at float32 activations only the summation order differs;
# at bf16 the gather path also rounds its probabilities to bf16, and
# every layer's rounding difference travels through the residual stream
F32_REL_TOL = 1e-3
BF16_REL_TOL = 0.1
# int8 serving is not bit-exact across reads that sum in another order
# (one int8 level can move), so card-vs-CPU tokens are held to the JAX
# package's int8 gate (tests/test_engine_matrix.py): every first token
# equal and a longest common prefix of at least this share of tokens
INT8_LCP_SHARE = 0.6
# the int8 extend read at the widths a catch-up wave may have: gemma3-1b's
# global layers (4 slots, 128-page tables; the first version refused
# S >= 22) and phi3's (32-page tables; S >= 41); and a row count one past
# a 64-row tile (G = 1) and four past one (G = 4); the gemma widths timed
EXTEND_WIDTHS = (("gemma3", dict(H=4, K=1, hd=256, n_blk=128),
                  (16, 21, 22, 64, 512)),
                 ("phi3", dict(n_blk=32), (41, 64)),
                 ("granite-moe", dict(H=16, K=8, hd=64, n_blk=128),
                  (16, 64)),
                 ("tile+1", dict(H=4, K=4, hd=128, n_blk=16), (65,)),
                 ("tile+4", dict(H=8, K=2, hd=64, n_blk=16), (17,)))
EXTEND_TIMED_GEMMA = (64, 512)
# granite-moe-1b-a400m's served int8 catch-up waves (16 query heads over
# 8 kv heads of 64, 128-page tables), timed at these chunk widths
EXTEND_TIMED_MOE = (16, 64)
# a short gemma3-1b int8 drive whose catch-up waves send 64 tokens a slot
# through the extend read, held to the gather read by the int8 gate
GEMMA_WIDE_SERVE = dict(GEMMA_SERVE, catch_chunk=64)
GEMMA_WIDE_TRAFFIC = (4, 600, 1000, 8)        # requests, prompts, new
# the seventh path: zamba2-7b (81 layers: 13 super-blocks of 5 mamba
# blocks and the shared attention block, then 3 mamba blocks) behind the
# pool-free engine; each admission prefill scans 68 mamba blocks through
# ssd_scan and runs 13 applications of the shared block through
# flash_attention
HYBRID_ARCH = "zamba2-7b"
HYBRID_SERVE = dict(SSM_SERVE)
HYBRID_TRAFFIC = (8, 16, 1000, 32)            # requests, prompts, new
# the eighth path: phi3-medium-14b at ServeConfig's defaults (the radix
# prefix cache on) with the hand-written reads, 4 slots, max_len 512.
# Household traffic: 8 users share one system prompt of 205 tokens (12
# pages of 16 and 13 tokens: it ends mid-page), then the same 5 persona
# tokens, then their own 8-200 tokens (seed 0), 32 new greedy tokens
# each.  User 0 comes alone and is stepped to its first token, so its
# chain is published in flight; users 1-7 come together after it.
SHARED_SERVE = dict(max_len=512, use_pallas_paged=True)
SHARED_SYS, SHARED_PERSONA, SHARED_TAIL = 205, 5, (8, 200)
SHARED_USERS, SHARED_NEW = 8, 32
SHARED_DEPTH = 20                           # of phi3's 40 layers
SHARED_STORE = ROOT / "build" / "serve_shared_store.npz"
# the ninth path: granite-moe-1b-a400m (24 layers of 32 experts, top 8,
# capacity factor 1.25) at GEMMA_SERVE's settings and traffic: prompts
# past the largest bucket (512) catch up in 16-token extend waves.  A
# 4-slot decode wave grants each expert ceil(4 * 8 * 1.25 / 32) = 2 rows
MOE_ARCH = "granite-moe-1b-a400m"
MOE_SERVE = dict(GEMMA_SERVE)
MOE_TRAFFIC = GEMMA_TRAFFIC
MOE_CLI_ARGV = ("--arch", MOE_ARCH, "--scale", "full")
# the routing check's admission batch (rows, bucket), and the distance
# of two sorted router logits below which the card and the CPU may order
# them differently (float32 sums in another order)
MOE_ROUTE_ROWS = (4, 512)
ROUTER_NEAR_TIE = 1e-4
# the tenth path: the families whose requests carry extras (the stub
# frontends' image or audio embeddings).  internvl2-76b at full width
# (d_model 8192, 64 query heads over 8 kv heads of 128, d_ff 28672, vocab
# 128256, 256 image tokens of 3200) cut to 32 of its 80 layers (29.57B
# parameters, 59.1 GB in bf16; all 80 would be 141 GB); 4 slots of
# max_len 1024, buckets to 512, chunked prefill with 16-token chunks: a
# request prefills its image and first 16 text tokens, the rest catches
# up in extend waves; 8 requests of 16-400 text tokens, each its own
# image, 32 new tokens
VLM_ARCH = "internvl2-76b"
VLM_LAYERS = 32
VLM_SERVE = dict(max_slots=4, max_len=1024, policy="priority",
                 prefill_buckets=(16, 32, 64, 128, 256, 512),
                 chunked_prefill=True, catch_chunk=16)
VLM_TRAFFIC = (8, 16, 400, 32)                # requests, prompts, new
# the prefix cache at ServeConfig()'s other defaults, max_len 1024 and
# buckets to 512: serve_shared's household traffic with one image for
# users 0-7 and a ninth user with another image and user 1's text
VLM_SHARED_SERVE = dict(max_len=1024, use_pallas_paged=True,
                        prefill_buckets=(16, 32, 64, 128, 256, 512))
VLM_DRAFT_LAYERS = 2
# whisper-base at full size (6 encoder and 6 decoder layers of 512, 8
# heads of 64, 1500 audio frames): max_len 448 (its decoder position
# table), buckets to 128, prompts to 300 catch up in 16-token extend
# waves; then the serve CLI at its defaults
WHISPER_ARCH = "whisper-base"
WHISPER_SERVE = dict(max_slots=4, max_len=448, policy="priority",
                     prefill_buckets=(16, 32, 64, 128), catch_chunk=16)
WHISPER_TRAFFIC = (8, 16, 300, 32)            # requests, prompts, new
WHISPER_CLI_ARGV = ("--arch", WHISPER_ARCH, "--scale", "full")
# the paged reads at the two families' served shapes, 64-page tables:
# internvl2-76b's G = 8 at hd 128 and whisper-base's G = 1 at hd 64
# (name, shape, pools cycled when timed, extend widths)
EXTRAS_PAGED = (("internvl2", dict(H=64, K=8, hd=128, n_blk=64), VLM_LAYERS,
                 (5, 16)),
                ("whisper", dict(H=8, K=8, hd=64, n_blk=64), 6, (16,)))
# the int8 draft's projections of internvl2-76b (K, N): the GEMV at the
# decode rows, the M > 8 kernel at these M (768: one draft admission
# row of 256 image and 512 text positions)
EXTEND_WIDTHS += tuple((name, shape, widths)
                       for name, shape, _, widths in EXTRAS_PAGED)
QM_VLM = {"wq / wo": (8192, 8192), "wk / wv": (8192, 1024),
          "w_gate / w_up": (8192, 28672), "w_down": (28672, 8192)}
QM_VLM_M = (9, 64, 768)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def idle_power_w(samples: int = 5) -> list:
    """``nvidia-smi``'s power.draw (W), read ``samples`` times in a row
    before the script has put any work on the card: the idle card's
    draw, which the hub's entry in ``core.perf_model`` states."""
    out = []
    for _ in range(samples):
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        out.append(float(res.stdout.strip().splitlines()[0]))
    return out


def ptxas_report(log: Path, contains: str) -> dict:
    """{kernel: [ptxas 'Used ...' / spill lines]} from an ``nvcc
    -Xptxas=-v`` log, for the entry functions whose (mangled) name holds
    ``contains``."""
    report, name = {}, None
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
            name = name if contains in name else None
        elif name and ("Used" in ln or "spill" in ln):
            report.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return report


def _sync(torch) -> None:
    """Bring a fault of the kernels launched so far to light here."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _release(torch) -> None:
    """Free what the last phase held before the next one measures its
    peak memory: the call counters of ``_count_calls`` close reference
    cycles through the engine they wrap, which only the cycle collector
    frees."""
    gc.collect()
    torch.cuda.empty_cache()


def _zero(kernels) -> None:
    """Set every kernel wrapper's launch count to 0."""
    for mod in kernels.values():
        mod.launches = 0


def _counts(kernels) -> dict:
    return {name: mod.launches for name, mod in kernels.items()}


def _clock_ms() -> float:
    from repro_torch.serving.telemetry import default_clock
    return default_clock() * 1e3


def cuda_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``iters`` calls, back
    to back on the device: the stream is held busy (``torch.cuda._sleep``)
    for longer than the host takes to queue the calls, so the host time
    between two launches, which the events would otherwise time as idle
    device time, does not count.  The host's own cost of a call is not a
    kernel's time; the serve phases time it end to end."""
    fn(0)
    torch.cuda.synchronize()
    t0 = _clock_ms()
    for i in range(1, warmup):
        fn(i)
    enqueue_ms = (_clock_ms() - t0) / max(warmup - 1, 1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_ms = min(1.5 * iters * enqueue_ms + 1.0, SLEEP_MAX_MS)
    torch.cuda._sleep(int(hold_ms * 1e-3 * SLEEP_CYCLES_PER_S))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: paged_attention against its plain version
# ---------------------------------------------------------------------------

def _paged_inputs(torch, dtype, *, q_dtype=None, layers=1, B=4, H=40,
                  K=10, hd=128, bs=16, n_blk=32, lengths=None, seed=0,
                  dev="cuda"):
    """q, a ``layers``-deep pool (nB = B * n_blk pages per layer), block
    tables with each row's pages scattered over the pool and one -1
    hole inside row 0, and ragged lengths; int8 pools come with their
    scales (symmetric per head_dim vector, as ``layers.quantize_kv``).
    q is in the page dtype, float32 over int8 pages, unless ``q_dtype``
    says otherwise (bfloat16 over int8 is what int8 serving runs).
    Queries at 3 x randn against K at 0.5 x randn make each softmax
    peaked, so a skipped page or a wrong head moves the output far past
    the tolerances."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    nB = B * n_blk
    if lengths is None:
        lengths = torch.randint(1, n_blk * bs + 1, (B,), generator=g)
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    perm = torch.randperm(nB, generator=g).to(torch.int32)
    bt = torch.full((B, n_blk), -1, dtype=torch.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // bs)
        bt[b, :n] = perm[b * n_blk:b * n_blk + n]
    if int(lengths[0]) > bs:
        bt[0, 0] = -1
    q = (torch.randn((B, H, hd), generator=g) * 3.0).to(dev)
    kp = torch.randn((layers, nB, bs, K, hd), generator=g).mul_(0.5).to(dev)
    vp = torch.randn((layers, nB, bs, K, hd), generator=g).mul_(0.5).to(dev)
    scales = {}
    if dtype == torch.int8:
        def quant(x):
            s = x.abs().amax(dim=-1) / 127.0 + 1e-8
            return (torch.clamp(torch.round(x / s[..., None]), -127, 127)
                    .to(torch.int8), s.contiguous())
        kp, ks = quant(kp)
        vp, vs = quant(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    if q_dtype is None:
        q_dtype = torch.float32 if dtype == torch.int8 else dtype
    return q.to(q_dtype), kp, vp, bt.to(dev), lengths.to(dev), scales


def _roofline(nbytes: int, ops: int, page_dtype) -> tuple:
    """Least time (ms) of moving ``nbytes`` through device memory and
    doing ``ops`` operations at the peak rate of the page type: the
    larger of the two, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[str(page_dtype).replace("torch.", "")]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _visible_context(torch, bt, lengths, bs):
    """(B,) count of each row's positions t < lengths[b] on allocated
    pages: the context rows a paged read must load."""
    pos = torch.arange(bt.shape[1] * bs, device=bt.device)
    valid = (pos[None, :] < lengths[:, None].long()) \
        & torch.repeat_interleave(bt >= 0, bs, dim=1)
    return valid.sum(dim=1)


def _page_row_bytes(kp, scales) -> int:
    """Bytes of one position's K and V rows over all kv heads (and their
    scales on an int8 pool)."""
    K, hd = kp.shape[-2:]
    return 2 * K * hd * kp.element_size() + (2 * K * 4 if scales else 0)


def _bound(torch, q, kp, bt, lengths, scales):
    """Least time (ms) of one decode read on these inputs: every input
    byte the function needs read once (q, tables, lengths, and the K/V
    rows — plus scales — of each row's valid positions on allocated
    pages), the output written once; against the operations it does
    over the peak rate of the page type.  Returns (ms, "bytes" |
    "operations")."""
    B, H, hd = q.shape
    tokens = int(_visible_context(torch, bt, lengths, kp.shape[-3]).sum())
    nbytes = (2 * q.numel() * q.element_size() + bt.numel() * 4
              + lengths.numel() * 4 + tokens * _page_row_bytes(kp, scales))
    return _roofline(nbytes, 4 * H * hd * tokens, kp.dtype)


def _sms(torch, dev) -> int:
    """SMs of the card (an H100's 132 for a CPU rehearsal)."""
    if dev == "cpu":
        return 132
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _ptxas(name: str, contains: str) -> dict:
    """ptxas lines of kernel library ``name``'s entry functions whose
    mangled name holds ``contains``."""
    from repro_torch.kernels import build
    log = build.library_path(name).with_suffix(".log")
    return ptxas_report(log, contains) if log.exists() else {}


def _ptxas_bf16(name: str) -> dict:
    """ptxas lines of a kernel's instantiations with a bf16 type."""
    return _ptxas(name, "13__nv_bfloat16")


def _boundary_lengths(plan, bs, n_blk, S=0):
    """Row lengths (or pos, with ``S`` suffix tokens behind them) on the
    split boundaries of ``plan``: exactly two splits, one page short of
    them, the whole table (its last split full) and, for the row that
    gets a hole, a whole table but three positions."""
    edge = 2 * plan.pages * bs
    return [edge, edge - bs, n_blk * bs - S, n_blk * bs - S - 3]


def _split_holes(bt, plan):
    """-1 over every table entry of split 1 of the last row: that split
    reads no page."""
    bt[-1, plan.pages:2 * plan.pages] = -1


def _decode_plans(torch, pa, q, kp, bt, dev):
    """The wrapper's plan for these shapes, and the same plan with scores
    and p.v moved from the tensor cores to the CUDA cores (None if it has
    no tensor cores to move from)."""
    B, H, hd = q.shape
    K, bs = kp.shape[-2], kp.shape[-3]
    plan = pa.paged_plan(B, K, H // K, 1, bt.shape[1], bs, hd, kp.dtype,
                         q.dtype, _sms(torch, dev))
    if not plan.mma:
        return plan, None
    return plan, plan._replace(mma=False, smem=pa.smem_bytes(
        H // K, hd, bs, plan.chunk, plan.stages, kp.element_size(),
        q.element_size(), suffix=False, mma=False))


def _decode_times(torch, pa, ref, timer, q, kp, vp, bt, ln, scale,
                  dev="cuda", scales=None):
    """Device ms of the kernel (and of its CUDA-core instantiation where
    it runs on the tensor cores, held to the same tolerance), its plain
    version and SDPA (over K/V gathered inside the timed call, and over
    K/V gathered beforehand; on int8 pages, with ``scales`` (L, nB, bs,
    K) per pool, gathered and dequantized) on a layer-deep pool cycled
    per call, and the bound."""
    import torch.nn.functional as F
    L = kp.shape[0]
    B, H, hd = q.shape
    K, bs = kp.shape[-2], kp.shape[2]
    scales = scales or {}

    def sc(i):
        return {k: v[i % L] for k, v in scales.items()}
    ms = timer(torch, lambda i: pa.paged_attention(
        q, kp[i % L], vp[i % L], bt, ln, scale=scale, **sc(i)))
    plan, cores = _decode_plans(torch, pa, q, kp[0], bt, dev)
    cuda_cores_ms = None
    if cores is not None:
        got = pa.paged_attention(q, kp[0], vp[0], bt, ln, scale=scale,
                                 plan=cores, **sc(0)).float()
        exp = ref.paged_attention_ref(q.float(), kp[0], vp[0], bt, ln,
                                      scale=scale, **sc(0))
        if not torch.allclose(got, exp, **TOL["bfloat16"]):
            raise AssertionError("paged_attention on the CUDA cores: max "
                                 f"abs err {float((got - exp).abs().max())}")
        cuda_cores_ms = timer(torch, lambda i: pa.paged_attention(
            q, kp[i % L], vp[i % L], bt, ln, scale=scale, plan=cores,
            **sc(i)))
    plain_ms = timer(torch, lambda i: ref.paged_attention_ref(
        q, kp[i % L], vp[i % L], bt, ln, scale=scale, **sc(i)), iters=20,
        warmup=3)
    btc = bt.clamp(min=0).long()
    t = torch.arange(bt.shape[1] * bs, device=q.device)
    mask = ((t[None, :] < ln[:, None])
            & torch.repeat_interleave(bt >= 0, bs, dim=1))[:, None, None, :]
    q4 = q[:, :, None, :]

    def gathered(x, s=None):
        g = x[btc]
        if s is not None:
            g = (g.float() * s[btc][..., None]).to(q.dtype)
        return g.reshape(B, -1, K, hd).transpose(1, 2)

    def library(l):
        return F.scaled_dot_product_attention(
            q4, gathered(kp[l], scales.get("k_scale", [None] * L)[l]),
            gathered(vp[l], scales.get("v_scale", [None] * L)[l]),
            attn_mask=mask, scale=scale, enable_gqa=True)
    lib_err = float((library(0)[:, :, 0].float() - ref.paged_attention_ref(
        q, kp[0], vp[0], bt, ln, scale=scale, **sc(0)).float()).abs().max())
    library_ms = timer(torch, lambda i: library(i % L))
    kg = [gathered(kp[l], scales.get("k_scale", [None] * L)[l]).contiguous()
          for l in range(L)]
    vg = [gathered(vp[l], scales.get("v_scale", [None] * L)[l]).contiguous()
          for l in range(L)]
    pregathered_ms = timer(torch, lambda i: F.scaled_dot_product_attention(
        q4, kg[i % L], vg[i % L], attn_mask=mask, scale=scale,
        enable_gqa=True))
    del kg, vg
    bound_ms, bound_by = _bound(torch, q, kp[0], bt, ln, sc(0))
    return {"ms": ms, "cuda_cores_ms": cuda_cores_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_ms_gather_excluded": pregathered_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_max_abs_err": lib_err,
            "lengths": [int(x) for x in ln.tolist()], "pools": L,
            "plan": plan._asdict(),
            "shape": f"B={B} H={H} K={K} hd={hd} bs={bs} "
            f"n_blk={bt.shape[1]} {str(kp.dtype).replace('torch.', '')}"}


def check_paged_attention(torch, pa, ref, timer, dev="cuda"):
    """Hold the kernel against its plain version on every case, on the
    split plan's boundaries and at gemma3-1b's global-layer shape; two
    calls bitwise equal; a merge that drops the last split's partial
    outside the tolerance; time the kernel (and its plain version and a
    library call) at the serving, long-context and gemma shapes."""
    errs, moves = {}, {}
    worst = 0.0

    def held(tol, case, q, kp, vp, bt, ln, **kw):
        nonlocal worst
        out = pa.paged_attention(q, kp, vp, bt, ln, **kw)
        _sync(torch)
        exp = ref.paged_attention_ref(q.float(), kp, vp, bt, ln, **kw)
        err = float((out.float() - exp).abs().max())
        if not torch.allclose(out.float(), exp, **TOL[tol]):
            raise AssertionError(f"paged_attention {case}: max abs err "
                                 f"{err} beyond tolerance {TOL[tol]}")
        errs[case] = err
        worst = max(worst, err)
        return out

    for seed, (name, pages, q_dtype, tol) in enumerate(CASES):
        q, kp, vp, bt, ln, sc = _paged_inputs(
            torch, getattr(torch, pages), q_dtype=getattr(torch, q_dtype),
            seed=seed, dev=dev)
        sc = {k: v[0] for k, v in sc.items()}
        args = (q, kp[0], vp[0], bt, ln)
        held(tol, f"{name}/softcap0", *args, scale=128 ** -0.5, **sc)
        capped = held(tol, f"{name}/softcap50/scale1", *args, scale=1.0,
                      softcap=50.0, **sc).float()
        free = held(tol, f"{name}/softcap0/scale1", *args, scale=1.0,
                    **sc).float()
        moves[name] = float((capped - free).abs().max())
        if moves[name] <= CAP_MOVES:
            raise AssertionError(f"paged_attention {name}: softcap 50 moved "
                                 f"the output by only {moves[name]}")
    # an inactive slot (all -1, length 0) reads as 0 in the kernel
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, seed=99,
                                         dev=dev)
    bt[3] = -1
    ln[3] = 0
    out = pa.paged_attention(q, kp[0], vp[0], bt, ln, scale=128 ** -0.5)
    _sync(torch)
    if not bool((out[3] == 0).all()):
        raise AssertionError("paged_attention: an empty row is not 0")

    # lengths on the plan's split boundaries, a hole that empties a
    # split; two calls bitwise equal; the last split's partial dropped
    plan = pa.paged_plan(4, 10, 4, 1, 32, 16, 128, torch.bfloat16,
                         torch.bfloat16, _sms(torch, dev))
    boundary = {}
    for name, pages, q_dtype, tol in CASES:
        q, kp, vp, bt, ln, sc = _paged_inputs(
            torch, getattr(torch, pages), q_dtype=getattr(torch, q_dtype),
            lengths=_boundary_lengths(plan, 16, 32), seed=21, dev=dev)
        _split_holes(bt, plan)
        sc = {k: v[0] for k, v in sc.items()}
        kw = dict(scale=1.0, softcap=50.0, **sc)
        out = held(tol, f"{name}/split boundaries", q, kp[0], vp[0], bt, ln,
                   **kw)
        again = pa.paged_attention(q, kp[0], vp[0], bt, ln, **kw)
        _sync(torch)
        if not torch.equal(out, again):
            raise AssertionError(f"paged_attention {name}: two calls differ")
        exp = ref.paged_attention_ref(q.float(), kp[0], vp[0], bt, ln, **kw)
        broken = pa.split_reference(q, kp[0], vp[0], bt, ln, plan,
                                    drop=plan.splits - 1, **kw)
        boundary[name] = float((broken - exp).abs().max())
        if torch.allclose(broken, exp, **TOL[tol]):
            raise AssertionError(f"paged_attention {name}: a merge without "
                                 f"the last split passes the tolerance")

    # gemma3-1b's global layers: 4 query heads over one kv head of 256
    gemma = dict(B=4, H=4, K=1, hd=256, n_blk=256)
    g = torch.Generator(device="cpu").manual_seed(5)
    gemma_len = torch.randint(1, 256 * 16 + 1, (4,), generator=g)
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, layers=8,
                                         lengths=gemma_len, seed=31,
                                         dev=dev, **gemma)
    held("bfloat16", "gemma3 global", q, kp[0], vp[0], bt, ln,
         scale=256 ** -0.5)
    timed_gemma = _decode_times(torch, pa, ref, timer, q, kp, vp, bt, ln,
                                256 ** -0.5, dev)
    del q, kp, vp

    # gemma3-1b's served decode waves: 128-page tables (max_len 2048) at
    # its traffic's lengths (prompts 16-1000 plus 32 new tokens), bf16
    # pages timed (16 pools cycled), int8 pages under bf16 queries held
    served = dict(B=4, H=4, K=1, hd=256, n_blk=128)
    g = torch.Generator(device="cpu").manual_seed(6)
    served_len = torch.randint(17, 1000 + 32 + 1, (4,), generator=g)
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, layers=16,
                                         lengths=served_len, seed=33,
                                         dev=dev, **served)
    held("bfloat16", "gemma3 served", q, kp[0], vp[0], bt, ln,
         scale=256 ** -0.5)
    timed_served = _decode_times(torch, pa, ref, timer, q, kp, vp, bt, ln,
                                 256 ** -0.5, dev)
    del q, kp, vp
    q, kp, vp, bt, ln, sc = _paged_inputs(torch, torch.int8,
                                          q_dtype=torch.bfloat16,
                                          lengths=served_len, seed=34,
                                          dev=dev, **served)
    held("bfloat16", "gemma3 served int8", q, kp[0], vp[0], bt, ln,
         scale=256 ** -0.5, **{k: v[0] for k, v in sc.items()})
    del q, kp, vp

    # granite-moe-1b-a400m's served decode waves: 16 query heads over 8
    # kv heads of 64 (G = 2), 128-page tables (max_len 2048) at its
    # traffic's lengths (prompts 16-1000 plus 32 new tokens); bf16 pages
    # and int8 pages under bf16 queries, each held and timed (24 pools,
    # one a layer, cycled)
    moe_shape = dict(B=4, H=16, K=8, hd=64, n_blk=128)
    g = torch.Generator(device="cpu").manual_seed(8)
    moe_len = torch.randint(17, 1000 + 32 + 1, (4,), generator=g)
    timed_moe = {}
    for pages in (torch.bfloat16, torch.int8):
        q, kp, vp, bt, ln, sc = _paged_inputs(torch, pages,
                                              q_dtype=torch.bfloat16,
                                              layers=24, lengths=moe_len,
                                              seed=36, dev=dev, **moe_shape)
        name = str(pages).replace("torch.", "")
        held("bfloat16", f"granite-moe served {name}", q, kp[0], vp[0], bt,
             ln, scale=64 ** -0.5, **{k: v[0] for k, v in sc.items()})
        timed_moe[name] = _decode_times(torch, pa, ref, timer, q, kp, vp, bt,
                                        ln, 64 ** -0.5, dev, scales=sc)
        del q, kp, vp, sc

    # the vlm and encdec families' served decode reads (EXTRAS_PAGED):
    # bf16 and int8 pages under bf16 queries, the first row over its
    # whole table, each held, its plan's merge without the last split
    # shown to fail, and timed (one pool a layer, cycled)
    timed_extras, extras_broken = {}, {}
    for arch, shape, layers, _ in EXTRAS_PAGED:
        g = torch.Generator(device="cpu").manual_seed(12)
        ext_len = torch.randint(17, shape["n_blk"] * 16 + 1, (4,),
                                generator=g)
        ext_len[0] = shape["n_blk"] * 16
        hd = shape["hd"]
        for pages in (torch.bfloat16, torch.int8):
            q, kp, vp, bt, ln, sc = _paged_inputs(
                torch, pages, q_dtype=torch.bfloat16, layers=layers,
                lengths=ext_len, seed=37, dev=dev, B=4, **shape)
            name = f"{arch} {str(pages).replace('torch.', '')}"
            kw = dict(scale=hd ** -0.5, **{k: v[0] for k, v in sc.items()})
            held("bfloat16", name, q, kp[0], vp[0], bt, ln, **kw)
            plan = _decode_plans(torch, pa, q, kp[0], bt, dev)[0]
            exp = ref.paged_attention_ref(q.float(), kp[0], vp[0], bt, ln,
                                          **kw)
            broken = pa.split_reference(q, kp[0], vp[0], bt, ln, plan,
                                        drop=plan.splits - 1, **kw)
            extras_broken[name] = float((broken - exp).abs().max())
            if plan.splits < 2 or torch.allclose(broken, exp,
                                                 **TOL["bfloat16"]):
                raise AssertionError(f"paged_attention {name}: a merge "
                                     f"without the last split passes the "
                                     f"tolerance ({plan})")
            timed_extras[name] = _decode_times(torch, pa, ref, timer, q, kp,
                                               vp, bt, ln, hd ** -0.5, dev,
                                               scales=sc)
            del q, kp, vp, sc

    # 4 rows of 4096 tokens (phi3-medium-4k's window), 8 pools (670 MB)
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, layers=8,
                                         n_blk=256, lengths=[4096] * 4,
                                         seed=41, dev=dev)
    held("bfloat16", "long 4 x 4096", q, kp[0], vp[0], bt, ln,
         scale=128 ** -0.5)
    timed_long = _decode_times(torch, pa, ref, timer, q, kp, vp, bt, ln,
                               128 ** -0.5, dev)
    del q, kp, vp

    # one row at long_prefill's last context: an 8192-token prompt and
    # its 32 new tokens (515 pages), 8 pools (340 MB)
    ctx = LONG_PROMPT + LONG_NEW
    q, kp, vp, bt, ln, _ = _paged_inputs(
        torch, torch.bfloat16, layers=8, B=1,
        n_blk=LONG_SERVE["max_len"] // 16, lengths=[ctx], seed=43, dev=dev)
    held("bfloat16", f"long_prefill 1 x {ctx}", q, kp[0], vp[0], bt, ln,
         scale=128 ** -0.5)
    timed_long_prefill = _decode_times(torch, pa, ref, timer, q, kp, vp,
                                       bt, ln, 128 ** -0.5, dev)
    del q, kp, vp

    # the serving path's shapes: bf16 pages, 4 slots with the serve
    # phase's prompt+generation lengths, one pool per layer (40 pools,
    # 420 MB) cycled per call so L2 holds no layer's pages
    g = torch.Generator(device="cpu").manual_seed(7)
    lengths = torch.randint(MIN_PROMPT + 1, MAX_PROMPT + MAX_NEW + 1, (4,),
                            generator=g)
    q, kp, vp, bt, ln, _ = _paged_inputs(torch, torch.bfloat16, layers=40,
                                         lengths=lengths, seed=11,
                                         dev=dev)
    held("bfloat16", "serve timed", q, kp[0], vp[0], bt, ln,
         scale=128 ** -0.5)
    row = _decode_times(torch, pa, ref, timer, q, kp, vp, bt, ln,
                        128 ** -0.5, dev)
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:140",
        "max_abs_err": worst, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }, {"errors": errs, "tolerance": TOL, "softcap50_moves": moves,
        "plan_serve": plan._asdict(),
        "broken_merge_without_last_split_err": boundary,
        "extras_broken_merge_err": extras_broken,
        "timed": {"serve": row, "long": timed_long,
                  "long_prefill": timed_long_prefill, "gemma3": timed_gemma,
                  "gemma3_served": timed_served,
                  "granite_moe_served": timed_moe,
                  "extras_served": timed_extras},
        "library_call": "F.scaled_dot_product_attention(enable_gqa=True) "
        "over K/V gathered inside the timed call (library_ms); "
        "library_ms_gather_excluded gathers beforehand",
        "ptxas_bf16": _ptxas_bf16("paged_attention")}


# ---------------------------------------------------------------------------
# phase 3: paged_extend_attention against its plain version
# ---------------------------------------------------------------------------

def _extend_inputs(torch, dtype, *, q_dtype=None, layers=1, B=4, S=4, H=40,
                   K=10, hd=128, bs=16, n_blk=32, pos=None, seed=0,
                   dev="cuda"):
    """q (B, S, H, hd) at 3 x randn, the suffix k_new / v_new at 0.5 x
    randn in q's dtype, and a ``layers``-deep pool from
    ``_paged_inputs`` whose tables cover each row's pos + S positions.
    By default row 0 has a -1 hole below its pos and the last row sits
    at pos 0 (it reads no page); stale bytes fill every page past each
    row's pos.  q is float32 over int8 pages unless ``q_dtype`` says
    otherwise."""
    g = torch.Generator(device="cpu").manual_seed(seed + 1000)
    if pos is None:
        pos = torch.randint(bs + 1, n_blk * bs - S + 1, (B,), generator=g)
        pos[-1] = 0
    pos = torch.as_tensor(pos, dtype=torch.int32)
    _, kp, vp, bt, _, scales = _paged_inputs(
        torch, dtype, layers=layers, B=B, H=H, K=K, hd=hd, bs=bs,
        n_blk=n_blk, lengths=pos + S, seed=seed, dev=dev)
    q_dtype = q_dtype or (torch.float32 if dtype == torch.int8 else dtype)
    q = (torch.randn((B, S, H, hd), generator=g) * 3.0).to(q_dtype).to(dev)
    kn = (torch.randn((B, S, K, hd), generator=g) * 0.5).to(q_dtype).to(dev)
    vn = (torch.randn((B, S, K, hd), generator=g) * 0.5).to(q_dtype).to(dev)
    return q, kp, vp, kn, vn, bt, pos.to(dev), scales


def _extend_bound(torch, q, kp, kn, bt, pos, scales):
    """Least time (ms) of one extend read on these inputs: q, k_new,
    v_new, tables and pos read once, the K/V rows (plus scales) of each
    row's context below pos on allocated pages read once, the output
    written once; against 4 * hd operations per (query head, visible
    key) pair over the peak rate of the page type."""
    B, S, H, hd = q.shape
    ctx = _visible_context(torch, bt, pos, kp.shape[-3])
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * kn.numel() * kn.element_size()
              + bt.numel() * 4 + pos.numel() * 4
              + int(ctx.sum()) * _page_row_bytes(kp, scales))
    pairs = H * (S * int(ctx.sum()) + B * S * (S + 1) // 2)
    return _roofline(nbytes, 4 * hd * pairs, kp.dtype)


def _extend_times(torch, pea, ref, timer, q, kp, vp, kn, vn, bt, pos, sc,
                  scale):
    """Device ms of the extend kernel (bf16 q over int8 pages), its plain
    version and the library yardstick (never called by the port: gather
    and dequantize the context, then SDPA over context + suffix with a
    boolean mask) on a layer-deep pool cycled per call, the kernel held
    to the bf16 tolerance, and the bound."""
    import torch.nn.functional as F
    ks, vs = sc["k_scale"], sc["v_scale"]
    L = kp.shape[0]
    B, S, H, hd = q.shape
    K, bs = kp.shape[-2], kp.shape[2]

    def kernel(i):
        return pea.paged_extend_attention(q, kp[i % L], vp[i % L], kn, vn,
                                          bt, pos, scale=scale,
                                          k_scale=ks[i % L],
                                          v_scale=vs[i % L])
    ms = timer(torch, kernel)
    plain_ms = timer(torch, lambda i: ref.paged_extend_attention_ref(
        q, kp[i % L], vp[i % L], kn, vn, bt, pos, scale=scale,
        k_scale=ks[i % L], v_scale=vs[i % L]), iters=20, warmup=3)

    btc = bt.clamp(min=0).long()
    n_ctx = bt.shape[1] * bs
    t = torch.arange(n_ctx, device=q.device)
    ctx_ok = (t[None, :] < pos[:, None]) \
        & torch.repeat_interleave(bt >= 0, bs, dim=1)
    i = torch.arange(S, device=q.device)
    mask = torch.cat([ctx_ok[:, None, :].expand(B, S, n_ctx),
                      (i[None, :] <= i[:, None])[None].expand(B, S, S)],
                     dim=-1)[:, None]                       # (B,1,S,T)
    qt = q.transpose(1, 2)

    def library(j):
        l = j % L
        kg = (kp[l][btc].float() * ks[l][btc][..., None]).to(q.dtype)
        vg = (vp[l][btc].float() * vs[l][btc][..., None]).to(q.dtype)
        k_all = torch.cat([kg.reshape(B, n_ctx, K, hd), kn], dim=1)
        v_all = torch.cat([vg.reshape(B, n_ctx, K, hd), vn], dim=1)
        return F.scaled_dot_product_attention(
            qt, k_all.transpose(1, 2), v_all.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True).transpose(1, 2)
    exp = ref.paged_extend_attention_ref(
        q.float(), kp[0], vp[0], kn.float(), vn.float(), bt, pos,
        scale=scale, k_scale=ks[0], v_scale=vs[0])
    lib_err = float((library(0).float() - exp).abs().max())
    out = kernel(0).float()
    kernel_err = float((out - exp).abs().max())
    if not torch.allclose(out, exp, **TOL["bfloat16"]):
        raise AssertionError(f"paged_extend_attention timed case (bf16 q, "
                             f"int8 pages, {B} x {S} x {H} heads, hd {hd}): "
                             f"max abs err {kernel_err} beyond tolerance "
                             f"{TOL['bfloat16']}")
    library_ms = timer(torch, library)
    sc0 = {k: v[0] for k, v in sc.items()}
    bound_ms, bound_by = _extend_bound(torch, q, kp[0], kn, bt, pos, sc0)
    plan = pea.paged_plan(B, K, H // K, S, bt.shape[1], bs, hd, kp.dtype,
                          q.dtype, _sms(torch, q.device), suffix=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_max_abs_err": kernel_err, "library_max_abs_err": lib_err,
            "pos": [int(x) for x in pos.tolist()], "pools": L,
            "plan": plan._asdict(),
            "shape": f"B={B} S={S} H={H} K={K} hd={hd} bs={bs} "
            f"n_blk={bt.shape[1]} int8"}


def check_paged_extend_attention(torch, pea, ref, timer, dev="cuda"):
    """Hold the extend kernel against its plain version on every case, on
    the split plan's boundaries and at gemma3-1b's global-layer shape;
    two calls bitwise equal; a merge that drops the last split's partial
    outside the tolerance; time the kernel (and its plain version and a
    library call) at the serving path's shapes."""
    errs, moves = {}, {}
    worst = 0.0

    def plain(q, kp, vp, kn, vn, bt, pos, **kw):
        return ref.paged_extend_attention_ref(q.float(), kp, vp, kn.float(),
                                              vn.float(), bt, pos, **kw)

    def held(tol, case, *args, **kw):
        nonlocal worst
        out = pea.paged_extend_attention(*args, **kw)
        _sync(torch)
        exp = plain(*args, **kw)
        err = float((out.float() - exp).abs().max())
        if not torch.allclose(out.float(), exp, **TOL[tol]):
            raise AssertionError(f"paged_extend_attention {case}: max abs "
                                 f"err {err} beyond tolerance {TOL[tol]}")
        errs[case] = err
        worst = max(worst, err)
        return out.float()

    for seed, (name, pages, q_dtype, tol) in enumerate(CASES):
        q, kp, vp, kn, vn, bt, pos, sc = _extend_inputs(
            torch, getattr(torch, pages), q_dtype=getattr(torch, q_dtype),
            seed=seed, dev=dev)
        if int(bt[0, 0]) != -1 or int(pos[0]) <= kp.shape[2] \
                or int(pos[-1]) != 0:
            raise AssertionError("extend inputs lack the -1 hole below pos "
                                 "or the pos-0 row")
        sc = {k: v[0] for k, v in sc.items()}
        args = (q, kp[0], vp[0], kn, vn, bt, pos)
        held(tol, f"{name}/softcap0", *args, scale=128 ** -0.5, **sc)
        capped = held(tol, f"{name}/softcap50/scale1", *args, scale=1.0,
                      softcap=50.0, **sc)
        free = held(tol, f"{name}/softcap0/scale1", *args, scale=1.0, **sc)
        moves[name] = float((capped - free).abs().max())
        if moves[name] <= CAP_MOVES:
            raise AssertionError(f"paged_extend_attention {name}: softcap "
                                 f"50 moved the output by only {moves[name]}")

    # pos on the plan's split boundaries, a hole that empties a split, and
    # gemma3-1b's global-layer shape (one kv head of 256); two calls
    # bitwise equal; the last split's partial (the suffix's) dropped
    plan = pea.paged_plan(4, 10, 4, 4, 32, 16, 128, torch.int8,
                          torch.bfloat16, _sms(torch, dev), suffix=True)
    boundary = {}
    for name, pages, q_dtype, tol in CASES:
        q, kp, vp, kn, vn, bt, pos, sc = _extend_inputs(
            torch, getattr(torch, pages), q_dtype=getattr(torch, q_dtype),
            pos=_boundary_lengths(plan, 16, 32, S=4), seed=21, dev=dev)
        _split_holes(bt, plan)
        sc = {k: v[0] for k, v in sc.items()}
        kw = dict(scale=1.0, softcap=50.0, **sc)
        args = (q, kp[0], vp[0], kn, vn, bt, pos)
        out = held(tol, f"{name}/split boundaries", *args, **kw)
        again = pea.paged_extend_attention(*args, **kw).float()
        _sync(torch)
        if not torch.equal(out, again):
            raise AssertionError(f"paged_extend_attention {name}: two calls "
                                 f"differ")
        broken = pea.split_reference(*args, plan, drop=plan.splits - 1, **kw)
        exp = plain(*args, **kw)
        boundary[name] = float((broken - exp).abs().max())
        if torch.allclose(broken, exp, **TOL[tol]):
            raise AssertionError(f"paged_extend_attention {name}: a merge "
                                 f"without the last split passes the "
                                 f"tolerance")
    q, kp, vp, kn, vn, bt, pos, sc = _extend_inputs(
        torch, torch.int8, q_dtype=torch.bfloat16, H=4, K=1, hd=256,
        n_blk=256, seed=31, dev=dev)
    held("bfloat16", "gemma3 global", q, kp[0], vp[0], kn, vn, bt, pos,
         scale=256 ** -0.5, **{k: v[0] for k, v in sc.items()})

    # the widths a catch-up wave may have, bf16 q over int8 pages (a
    # -1 hole below row 0's pos, the last row at pos 0); each plan's
    # merge without its last split (the suffix's) must fail
    widths = {}
    for name, shape, widths_S in EXTEND_WIDTHS:
        for S in widths_S:
            q, kp, vp, kn, vn, bt, pos, sc = _extend_inputs(
                torch, torch.int8, q_dtype=torch.bfloat16, S=S,
                seed=40 + S, dev=dev, **shape)
            B, _, H, hd = q.shape
            K = kp.shape[-2]
            kw = dict(scale=hd ** -0.5, **{k: v[0] for k, v in sc.items()})
            args = (q, kp[0], vp[0], kn, vn, bt, pos)
            case = f"{name} S={S}"
            held("bfloat16", case, *args, **kw)
            plan = pea.paged_plan(B, K, H // K, S, bt.shape[1], 16, hd,
                                  torch.int8, torch.bfloat16,
                                  _sms(torch, dev), suffix=True)
            row = {"rows": H // K * S, "plan": plan._asdict()}
            if plan.splits > 1:
                broken = pea.split_reference(*args, plan,
                                             drop=plan.splits - 1, **kw)
                exp = plain(*args, **kw)
                row["broken_merge_err"] = float((broken - exp).abs().max())
                if torch.allclose(broken, exp, **TOL["bfloat16"]):
                    raise AssertionError(f"paged_extend_attention {case}: "
                                         "a merge without the last split "
                                         "passes the tolerance")
            widths[case] = row
            del q, kp, vp, kn, vn, args

    # timing at the serving path's shapes: a catch-up wave of 4 slots x 4
    # tokens at prompt positions past the largest prefill bucket (128),
    # bf16 queries over int8 pages, one pool per layer (40 pools) cycled
    # per call so L2 holds no layer's pages
    g = torch.Generator(device="cpu").manual_seed(7)
    S = 4
    pos = torch.randint(128, MAX_PROMPT - S + 1, (4,), generator=g)
    q, kp, vp, kn, vn, bt, pos, sc = _extend_inputs(
        torch, torch.int8, q_dtype=torch.bfloat16, layers=40, S=S, pos=pos,
        seed=11, dev=dev)
    row = _extend_times(torch, pea, ref, timer, q, kp, vp, kn, vn, bt, pos,
                        sc, 128 ** -0.5)
    worst = max(worst, row["kernel_max_abs_err"])
    del q, kp, vp

    # gemma3-1b's served int8 catch-up wave: 4 slots x 16 tokens past the
    # 512-token window over 128-page tables, 4 query heads over one kv
    # head of 256; 16 pools cycled
    g = torch.Generator(device="cpu").manual_seed(9)
    gpos = torch.randint(512, 2048 - 16 + 1, (4,), generator=g)
    args = _extend_inputs(torch, torch.int8, q_dtype=torch.bfloat16,
                          layers=16, S=16, H=4, K=1, hd=256, n_blk=128,
                          pos=gpos, seed=32, dev=dev)
    timed_gemma = _extend_times(torch, pea, ref, timer, *args, 256 ** -0.5)
    errs["gemma3 served chunk (S=16)"] = timed_gemma["kernel_max_abs_err"]
    worst = max(worst, timed_gemma["kernel_max_abs_err"])
    del args
    # and at wider catch-up chunks, 8 pools cycled
    timed_wide = {}
    for S in EXTEND_TIMED_GEMMA:
        gpos = torch.randint(512, 2048 - S + 1, (4,), generator=g)
        args = _extend_inputs(torch, torch.int8, q_dtype=torch.bfloat16,
                              layers=8, S=S, H=4, K=1, hd=256, n_blk=128,
                              pos=gpos, seed=33 + S, dev=dev)
        timed_wide[f"S={S}"] = _extend_times(torch, pea, ref, timer, *args,
                                             256 ** -0.5)
        worst = max(worst, timed_wide[f"S={S}"]["kernel_max_abs_err"])
        del args
    # granite-moe-1b-a400m's served int8 catch-up waves past the largest
    # bucket (512), 24 pools cycled
    timed_moe = {}
    for S in EXTEND_TIMED_MOE:
        mpos = torch.randint(512, 2048 - S + 1, (4,), generator=g)
        args = _extend_inputs(torch, torch.int8, q_dtype=torch.bfloat16,
                              layers=24, S=S, H=16, K=8, hd=64, n_blk=128,
                              pos=mpos, seed=50 + S, dev=dev)
        timed_moe[f"S={S}"] = _extend_times(torch, pea, ref, timer, *args,
                                            64 ** -0.5)
        worst = max(worst, timed_moe[f"S={S}"]["kernel_max_abs_err"])
        del args
    # the vlm and encdec families' served int8 catch-up and verify waves
    # past the vlm's image (EXTRAS_PAGED), one pool a layer, cycled
    timed_extras = {}
    for arch, shape, layers, widths_S in EXTRAS_PAGED:
        for S in widths_S:
            epos = torch.randint(256, shape["n_blk"] * 16 - S + 1, (4,),
                                 generator=g)
            args = _extend_inputs(torch, torch.int8, q_dtype=torch.bfloat16,
                                  layers=layers, S=S, pos=epos,
                                  seed=60 + S, dev=dev, **shape)
            timed_extras[f"{arch} S={S}"] = _extend_times(
                torch, pea, ref, timer, *args, shape["hd"] ** -0.5)
            worst = max(worst,
                        timed_extras[f"{arch} S={S}"]["kernel_max_abs_err"])
            del args
    return {
        "name": "paged_extend_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_extend_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:283",
        "max_abs_err": worst, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }, {"errors": errs, "tolerance": TOL, "softcap50_moves": moves,
        "timed_pos": row["pos"], "timed_S": S,
        "timed_kernel_max_abs_err_bf16": row["kernel_max_abs_err"],
        "timed_gemma3": timed_gemma, "timed_gemma3_wide": timed_wide,
        "timed_granite_moe": timed_moe,
        "timed_extras": timed_extras,
        "widths": widths,
        "library_call": "gather + dequantize, then "
        "F.scaled_dot_product_attention(enable_gqa=True) with a boolean "
        "mask, all timed",
        "library_max_abs_err": row["library_max_abs_err"],
        "plan_serve": plan._asdict(),
        "broken_merge_without_last_split_err": boundary,
        "ptxas_bf16": _ptxas_bf16("paged_extend_attention")}


# ---------------------------------------------------------------------------
# phase 3: quant_matmul against its plain version
# ---------------------------------------------------------------------------

def _qm_inputs(torch, qm, M, K, N, x_dtype, seed, dev="cuda"):
    """x at randn rounded to bfloat16 (held in ``x_dtype``), and a randn /
    sqrt(K) weight quantized per output channel (outputs of order 1)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((M, K), generator=g).to(torch.bfloat16).to(x_dtype)
    w = (torch.randn((K, N), generator=g) * K ** -0.5).to(dev)
    wq, scale = qm.quantize_weights(w)
    return x.to(dev), wq, scale


def _qm_bound(M, K, N, x_elt: int):
    """Least time (ms) of one call: x, the int8 weight and the scales
    read once, the output (x's dtype) written once, against 2MNK
    operations at the bfloat16 tensor-core rate."""
    nbytes = M * K * x_elt + K * N + 4 * N + M * N * x_elt
    return _roofline(nbytes, 2 * M * N * K, "bfloat16")


def _qm_cold(torch, w):
    """Copies of ``w`` that together exceed the 50 MB L2 cache by far, so
    a timer that walks them finds each weight in device memory, as the
    draft's 56 distinct projections a step do."""
    n = max(1, math.ceil(QM_COLD_BYTES / (w.numel() * w.element_size())))
    return [w] + [w.clone() for _ in range(n - 1)]


def time_gemv(torch, qm, ref, timer, M, K, N, *, seed=7, dev="cuda"):
    """Time the kernel at (M, K, N) with bf16 x on cold weights, beside
    its bound, the bf16 cuBLAS yardstick (torch.matmul on a bf16 copy of
    the dequantized weight, cold too) and the plain version."""
    x, wq, scale = _qm_inputs(torch, qm, M, K, N, torch.bfloat16,
                              seed=seed, dev=dev)
    wqs = _qm_cold(torch, wq)
    ms = timer(torch, lambda i: qm.quant_matmul(
        x, wqs[i % len(wqs)], scale, out_dtype=torch.bfloat16))
    del wqs
    w_bf16 = _qm_cold(torch, (wq.float() * scale[None, :]).to(torch.bfloat16))
    library_ms = timer(torch, lambda i: torch.matmul(x, w_bf16[i % len(w_bf16)]))
    del w_bf16
    row = {"shape": [M, K, N], "ms": ms, "library_ms": library_ms}
    row["plain_ms"] = timer(torch, lambda i: ref.quant_matmul_ref(
        x, wq, scale, out_dtype=torch.bfloat16), iters=20, warmup=3)
    row["bound_ms"], row["bound_by"] = _qm_bound(M, K, N, 2)
    row["weight_gb_per_s"] = K * N / (ms * 1e-3) / 1e9
    return row


def _qm_weight(torch, qm, K, N, seed, dev="cuda"):
    """A randn / sqrt(K) weight made on ``dev``, quantized per output
    channel: one per projection, shared by the M > 8 cases."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    return qm.quantize_weights(w)


def _qm_check(torch, ref, out, x, wq, scale, name, dt):
    """max |kernel - plain| of one call, raising beyond QM_TOL[dt]."""
    _sync(torch)
    exp = ref.quant_matmul_ref(x, wq, scale, out_dtype=torch.float32)
    err = float((out.float() - exp).abs().max())
    if out.dtype != getattr(torch, dt) or not torch.allclose(
            out.float(), exp, **QM_TOL[dt]):
        raise AssertionError(f"quant_matmul {name} {dt}: max abs err {err} "
                             f"beyond tolerance {QM_TOL[dt]}")
    return err


def check_quant_matmul(torch, qm, ref, timer, dev="cuda"):
    """Hold both kernels against their plain version (x in bf16 and f32,
    out_dtype = x's): the M <= 8 GEMV at the draft's decode shapes, a
    ragged one and one whose K is too short to split; the M > 8 kernel
    at QM_PREFILL_M rows against every projection and at QM_EDGES.  Show
    three broken versions fall outside the tolerance.  Two calls on the
    same inputs give bitwise-equal outputs, K split or not, in either
    kernel.  Time kernel, plain version and the bf16 yardstick at every
    decode shape and at QM_TIMED_M rows of every projection (cold
    weights), and sum one draft layer's seven decode launches."""
    errs, worst = {}, 0.0
    shapes = {f"decode {n}": (4, k, nn) for n, (k, nn) in QM_DECODE.items()}
    shapes["ragged"] = (3, 200, 72)
    shapes["unsplit"] = QM_UNSPLIT
    shapes.update({f"M > 8, {n}": s for n, s in QM_EDGES.items()})
    for i, (name, (M, K, N)) in enumerate(shapes.items()):
        for dt in ("bfloat16", "float32"):
            x, wq, scale = _qm_inputs(torch, qm, M, K, N, getattr(torch, dt),
                                      seed=i, dev=dev)
            out = qm.quant_matmul(x, wq, scale, out_dtype=getattr(torch, dt))
            err = _qm_check(torch, ref, out, x, wq, scale, name, dt)
            errs[f"{name} {M}x{K}x{N} {dt}"] = err
            worst = max(worst, err)
    # the M > 8 kernel at the draft's prefill rows, one weight a projection
    sms = _sms(torch, dev)
    plans = {}
    for i, (n, (K, N)) in enumerate(QM_DECODE.items()):
        wq, scale = _qm_weight(torch, qm, K, N, seed=100 + i, dev=dev)
        for M in QM_PREFILL_M:
            plans[f"M={M} {n}"] = qm.mma_plan(M, K, N, sms)._asdict()
            for dt in ("bfloat16", "float32"):
                g = torch.Generator(device=dev).manual_seed(M)
                x = torch.randn((M, K), generator=g, device=dev).to(
                    torch.bfloat16).to(getattr(torch, dt))
                out = qm.quant_matmul(x, wq, scale,
                                      out_dtype=getattr(torch, dt))
                err = _qm_check(torch, ref, out, x, wq, scale,
                                f"M={M} {n}", dt)
                errs[f"prefill M={M} {n} {dt}"] = err
                worst = max(worst, err)
        del wq, scale

    # the vlm int8 draft's projections (QM_VLM, K up to 28672): the GEMV
    # at 4 rows and the M > 8 kernel at QM_VLM_M, x in bf16 and f32; at
    # K = 28672, K short by one 32-row tile (4 rows) and by one 64-row
    # step (64 rows), on x at 3 x randn, must fall outside the tolerance
    vlm_broken = {}
    for i, (n, (K, N)) in enumerate(QM_VLM.items()):
        wq, scale = _qm_weight(torch, qm, K, N, seed=200 + i, dev=dev)
        for M in (4,) + QM_VLM_M:
            plans[f"vlm M={M} {n}"] = (
                qm.gemv_plan if M <= qm.GEMV_MAX_M else qm.mma_plan)(
                    M, K, N, sms)._asdict()
            for dt in ("bfloat16", "float32"):
                g = torch.Generator(device=dev).manual_seed(M)
                x = torch.randn((M, K), generator=g, device=dev).to(
                    torch.bfloat16).to(getattr(torch, dt))
                out = qm.quant_matmul(x, wq, scale,
                                      out_dtype=getattr(torch, dt))
                err = _qm_check(torch, ref, out, x, wq, scale,
                                f"vlm M={M} {n}", dt)
                errs[f"vlm M={M} {n} {dt}"] = err
                worst = max(worst, err)
        if K == max(k for k, _ in QM_VLM.values()):
            for M, cut, bname in ((4, 32, "k_short_one_tile"),
                                  (64, 64, "k_short_one_64_row_step")):
                g = torch.Generator(device=dev).manual_seed(M)
                x = 3.0 * torch.randn((M, K), generator=g, device=dev)
                exp = ref.quant_matmul_ref(x, wq, scale,
                                           out_dtype=torch.float32)
                v = ref.quant_matmul_ref(x[:, :K - cut], wq[:K - cut], scale,
                                         out_dtype=torch.float32)
                vlm_broken[bname] = float((v - exp).abs().max())
                if torch.allclose(v, exp, **QM_TOL["float32"]) \
                        or vlm_broken[bname] <= QM_BROKEN_MOVES:
                    raise AssertionError(
                        f"quant_matmul K={K}: the broken version {bname} "
                        f"moves the output by only {vlm_broken[bname]}")
        del wq, scale

    # two calls, bitwise equal: the split partials are summed in a fixed
    # order (both kernels; split and unsplit plans)
    repeat, rep_plans = {}, {}
    rep_shapes = dict((n, s) for n, s in shapes.items() if s[0] <= 8)
    rep_shapes["decode w_gate M=8"] = (8, *QM_DECODE["w_gate / w_up"])
    rep_shapes["prefill w_gate M=512"] = (512, *QM_DECODE["w_gate / w_up"])
    rep_shapes["prefill wk / wv M=512"] = (512, *QM_DECODE["wk / wv"])
    rep_shapes["prefill w_down M=64"] = (64, *QM_DECODE["w_down"])
    for name, (M, K, N) in rep_shapes.items():
        x, wq, scale = _qm_inputs(torch, qm, M, K, N, torch.bfloat16,
                                  seed=11, dev=dev)
        a = qm.quant_matmul(x, wq, scale, out_dtype=torch.float32)
        b = qm.quant_matmul(x, wq, scale, out_dtype=torch.float32)
        _sync(torch)
        plan = (qm.gemv_plan if M <= qm.GEMV_MAX_M else qm.mma_plan)(
            M, K, N, sms)
        rep_plans[name] = plan._asdict()
        repeat[name] = bool(torch.equal(a, b))
        if not repeat[name]:
            raise AssertionError(f"quant_matmul {name}: two calls differ by "
                                 f"{float((a - b).abs().max())}")
    for kernel_rows in ((0, 8), (9, 1 << 30)):
        split = [p["splits"] for n, p in rep_plans.items()
                 if kernel_rows[0] <= rep_shapes[n][0] <= kernel_rows[1]]
        if min(split) != 1 or max(split) == 1:
            raise AssertionError(f"quant_matmul: the repeatability shapes "
                                 f"must hold split and unsplit plans of "
                                 f"each kernel, got {rep_plans}")

    # what three broken kernels would return, from the plain version: the
    # scale along K (the square wq shape), K short by one 32-row tile, and
    # (M > 8) K short by one 64-row step
    moves = {}
    for M, broken_names in ((4, ("scale_on_k_axis", "k_short_one_tile")),
                            (64, ("k_short_one_64_row_step",))):
        K, N = QM_DECODE["wq / wo"]
        x, wq, scale = _qm_inputs(torch, qm, M, K, N, torch.float32, seed=0,
                                  dev=dev)
        exp = ref.quant_matmul_ref(x, wq, scale, out_dtype=torch.float32)
        cut = {"k_short_one_tile": 32, "k_short_one_64_row_step": 64}
        for k in broken_names:
            v = (x @ (wq.float() * scale[:, None]) if k == "scale_on_k_axis"
                 else ref.quant_matmul_ref(x[:, :K - cut[k]],
                                           wq[:K - cut[k]], scale,
                                           out_dtype=torch.float32))
            moves[k] = float((v - exp).abs().max())
            if torch.allclose(v, exp, **QM_TOL["float32"]) \
                    or moves[k] <= QM_BROKEN_MOVES:
                raise AssertionError(f"quant_matmul: the broken version {k} "
                                     f"moves the output by only {moves[k]}")

    # timing: bf16 x as the draft runs it; the yardstick (never called by
    # the port) is torch.matmul on the weight dequantized to bf16
    # beforehand: the same product without int8 weights, reading twice the
    # weight bytes
    times = {f"decode {n}": time_gemv(torch, qm, ref, timer, 4, k, nn,
                                      dev=dev)
             for n, (k, nn) in QM_DECODE.items()}
    for M in QM_TIMED_M:
        for n, (k, nn) in QM_DECODE.items():
            times[f"prefill M={M} {n}"] = time_gemv(torch, qm, ref, timer,
                                                    M, k, nn, dev=dev)
    for n, (k, nn) in QM_VLM.items():
        for M in (4, QM_VLM_M[-1]):
            times[f"vlm M={M} {n}"] = time_gemv(torch, qm, ref, timer, M, k,
                                                nn, dev=dev)
    layer = {k: sum(QM_LAYER_LAUNCHES[n] * times[f"decode {n}"][k]
                    for n in QM_DECODE)
             for k in ("ms", "library_ms", "bound_ms")}
    vlm_layer = {k: sum(QM_LAYER_LAUNCHES[n] * times[f"vlm M=4 {n}"][k]
                        for n in QM_VLM)
                 for k in ("ms", "library_ms", "bound_ms")}
    draft_prefill = {f"M={M}": {k: DRAFT_LAYERS * sum(
        QM_LAYER_LAUNCHES[n] * times[f"prefill M={M} {n}"][k]
        for n in QM_DECODE) for k in ("ms", "library_ms", "bound_ms")}
        for M in QM_TIMED_M}
    row = times["decode w_gate / w_up"]
    return {
        "name": "quant_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:50",
        "max_abs_err": worst, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }, {"errors": errs, "tolerance": QM_TOL, "broken_moves": moves,
        "vlm_broken_moves": vlm_broken,
        "vlm_draft_layer_seven_launches": vlm_layer,
        "bitwise_repeatable": repeat, "repeat_plans": rep_plans,
        "prefill_plans": plans, "timed": times,
        "draft_layer_seven_launches": layer,
        "draft_prefill_56_launches": draft_prefill,
        "row_shape": "decode w_gate, M=4 bf16",
        "cold_weights": f"timers walk copies of each weight totalling >= "
        f"{QM_COLD_BYTES / 1e6:.0f} MB",
        "library_call": "torch.matmul(x_bf16, w_bf16) with w dequantized to "
        "bf16 beforehand (twice the int8 weight bytes; not the same "
        "rounding)",
        "ptxas_wgmma": _ptxas(qm.NAME, "wgmma_kernel")}


# ---------------------------------------------------------------------------
# phase 3: ssd_scan against the plain chunked path
# ---------------------------------------------------------------------------

def _ssd_inputs(torch, b, l, dtype, *, seed=0, dev="cuda", h=SSD_H,
                p=SSD_P, n=SSD_N):
    """x, dt, A, B, C at mamba2-370m's width (or h, p, n), with x, B and C
    as strided views into one (b, l, h*p + 2n) tensor, as the model hands
    them to the scan.  dt in [0.001, 0.021] and A in [-2, -0.5] keep a
    chunk's decay at ~0.1, so the carried state moves the next chunk's
    rows by about their own size: a dropped state or a missing decay
    shows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    xbc = torch.cat([torch.randn((b, l, h * p), generator=g),
                     torch.randn((b, l, 2 * n), generator=g) * n ** -0.5],
                    dim=-1).to(dtype).to(dev)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = (torch.rand((b, l, h), generator=g) * 0.02 + 0.001).to(dev)
    A = -(torch.rand((h,), generator=g) * 1.5 + 0.5).to(dev)
    return x, dt, A, B, C


def _ssd_ops(b, l, h, p, n, Q) -> int:
    """Least operations of one scan: per (b, chunk) the score product
    C B^T once (every head shares B and C) over the causal pairs j <= i,
    Q (Q + 1) / 2 of them at n multiply-adds; per (b, h, chunk) the
    scores x (x dt) product over the same pairs at p, and the inter-chunk
    product and the state update at Q p n each."""
    nc = -(-l // Q)
    pairs = Q * (Q + 1) // 2
    return 2 * b * nc * (pairs * n + h * (pairs * p + 2 * Q * p * n))


def _ssd_bound(b, l, h, p, n, Q, x_elt: int, rate="float32"):
    """Least time (ms) of one scan: x, dt, A, B, C read once, y and the
    float32 final state written once, against ``_ssd_ops`` at the peak
    rate of ``rate``: bfloat16 for the bf16 instantiation, whose
    products run on the tensor cores, float32 for a scan on the CUDA
    cores."""
    nbytes = (2 * b * l * h * p * x_elt + b * l * h * 4 + h * 4
              + 2 * b * l * n * x_elt + b * h * p * n * 4)
    return _roofline(nbytes, _ssd_ops(b, l, h, p, n, Q), rate)


def _ssd_err(torch, got, want, dtype) -> tuple:
    """(max |got - want|, whether it is within SSD_TOL): float32 within
    SSD_F32_REL x max |want|; a bfloat16 y within one bfloat16 step of
    each value on top of that."""
    scale = float(want.abs().max())
    diff = (got.float() - want).abs()
    allowed = SSD_F32_REL * scale
    if dtype == torch.bfloat16:
        allowed = allowed + SSD_BF16_STEP * want.abs()
    return float(diff.max()), bool((diff <= allowed).all())


def _ssd_by_chunks(torch, ssm, x, dt, A, B, C, decay=True):
    """The plain chunked path one chunk at a time, the state carried in
    between: as the whole with ``decay``; without it, the broken version
    whose carried state skips each chunk's decay exp(cums_last)
    (state_c = state_{c-1} + local_c)."""
    ys, carried = [], None
    for i in range(0, x.shape[1], SSD_CHUNK):
        part = (x[:, i:i + SSD_CHUNK], dt[:, i:i + SSD_CHUNK], A,
                B[:, i:i + SSD_CHUNK], C[:, i:i + SSD_CHUNK], SSD_CHUNK)
        y, h_next = ssm.ssd_chunked(*part, h0=carried)
        ys.append(y)
        if not decay:
            local = ssm.ssd_chunked(*part)[1]
            h_next = local if carried is None else carried + local
        carried = h_next
    return torch.cat(ys, dim=1)


def check_ssd_scan(torch, ssd, ref, ssm, timer, dev="cuda"):
    """Hold the kernel against the model's plain chunked path in float32
    (``ssm.ssd_chunked`` without the kernel, on the same inputs rounded
    to the kernel's input type) at mamba2-370m's width and chunk for
    SSD_CASES (b 1 and 4, l 16 / 256 / 300 (ragged) / 1024 / 2048, up to
    8 chunks), at zamba2-7b's (112 heads, p 64, n 64) and at 30 heads, x
    in bf16 and f32; a split sequence continued through ``h0`` must
    equal the whole; three broken versions (the carried state dropped
    between chunks, the decay left out everywhere, the state passed
    without its decay) must land more than SSD_BROKEN_MOVES x max |y|
    away.  Times the kernel and the plain chunked path at SSD_TIMED (bf16,
    as the model serves) and its plain version (the sequential
    recurrence) at the first; no single PyTorch call computes this
    function."""
    errs, worst = {}, 0.0
    cases = [(b, l, {}) for b, l in SSD_CASES]
    cases += [(2, 1024, dict(zip("hpn", SSD_ZAMBA))), (4, 1024, {"h": 30})]
    for b, l, width in cases:
        for dt_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dt_name)
            x, dt, A, B, C = _ssd_inputs(torch, b, l, dtype, seed=b * l,
                                         dev=dev, **width)
            y, hf = ssd.ssd_scan(x, dt, A, B, C, chunk=SSD_CHUNK)
            _sync(torch)
            yr, hr = ssm.ssd_chunked(x.float(), dt, A, B.float(), C.float(),
                                     SSD_CHUNK)
            ey, oky = _ssd_err(torch, y, yr, dtype)
            eh, okh = _ssd_err(torch, hf, hr, torch.float32)
            name = f"b{b} l{l} {dt_name}" + "".join(
                f" {k}={v}" for k, v in width.items())
            if y.dtype != dtype or not (oky and okh) \
                    or not bool(torch.isfinite(y.float()).all()):
                raise AssertionError(
                    f"ssd_scan {name}: |y - plain| {ey}, |h - plain| {eh} "
                    f"(max |y| {float(yr.abs().max())})")
            errs[name] = {"y": ey, "h_final": eh}
            worst = max(worst, ey)
            del x, dt, B, C, y, hf, yr, hr
    # a split sequence: [0, 300) then [300, 1024) from its final state
    for dt_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dt_name)
        x, dt, A, B, C = _ssd_inputs(torch, 4, 1024, dtype, seed=5, dev=dev)
        y_all, h_all = ssm.ssd_chunked(x.float(), dt, A, B.float(),
                                       C.float(), SSD_CHUNK)
        _, h1 = ssd.ssd_scan(x[:, :300], dt[:, :300], A, B[:, :300],
                             C[:, :300], chunk=SSD_CHUNK)
        y2, h2 = ssd.ssd_scan(x[:, 300:], dt[:, 300:], A, B[:, 300:],
                              C[:, 300:], chunk=SSD_CHUNK, h0=h1)
        _sync(torch)
        ey, oky = _ssd_err(torch, y2, y_all[:, 300:], dtype)
        eh, okh = _ssd_err(torch, h2, h_all, torch.float32)
        if not (oky and okh):
            raise AssertionError(f"ssd_scan h0 continuation {dt_name}: "
                                 f"|y - whole| {ey}, |h - whole| {eh}")
        errs[f"h0 continuation {dt_name}"] = {"y": ey, "h_final": eh}

    # broken versions, from the plain chunked path
    x, dt, A, B, C = _ssd_inputs(torch, 4, 1024, torch.float32, seed=9,
                                 dev=dev)
    want, _ = ssm.ssd_chunked(x, dt, A, B, C, SSD_CHUNK)
    got, _ = ssd.ssd_scan(x, dt, A, B, C, chunk=SSD_CHUNK)
    scale = float(want.abs().max())
    broken = {
        "state_dropped": torch.cat([ssm.ssd_chunked(
            x[:, i:i + SSD_CHUNK], dt[:, i:i + SSD_CHUNK], A,
            B[:, i:i + SSD_CHUNK], C[:, i:i + SSD_CHUNK], SSD_CHUNK)[0]
            for i in range(0, 1024, SSD_CHUNK)], dim=1),
        "no_decay": ssm.ssd_chunked(x, dt, torch.zeros_like(A), B, C,
                                    SSD_CHUNK)[0],
        "state_passed_without_decay": _ssd_by_chunks(
            torch, ssm, x, dt, A, B, C, decay=False),
    }
    moves = {k: float((v - want).abs().max()) / scale
             for k, v in broken.items()}
    for k, v in moves.items():
        if v <= SSD_BROKEN_MOVES or _ssd_err(torch, broken[k], want,
                                             torch.float32)[1]:
            raise AssertionError(f"ssd_scan: the broken version {k} moves "
                                 f"y by only {v} x max |y|")
    if not _ssd_err(torch, got, want, torch.float32)[1] or not _ssd_err(
            torch, _ssd_by_chunks(torch, ssm, x, dt, A, B, C), want,
            torch.float32)[1]:
        raise AssertionError("ssd_scan: kernel (or the chunk-by-chunk plain "
                             "path) off the plain chunked path")

    # timing, bf16 as served; the row: the path's largest prefill
    times = {}
    for b, l in SSD_TIMED:
        x, dt, A, B, C = _ssd_inputs(torch, b, l, torch.bfloat16, seed=7,
                                     dev=dev)
        Q = min(SSD_CHUNK, l)
        row = {"ms": timer(torch, lambda i: ssd.ssd_scan(
            x, dt, A, B, C, chunk=SSD_CHUNK)),
            "chunked_path_ms": timer(torch, lambda i: ssm.ssd_chunked(
                x, dt, A, B, C, SSD_CHUNK), iters=5, warmup=1),
            "ops": _ssd_ops(b, l, SSD_H, SSD_P, SSD_N, Q)}
        for rate in ("bfloat16", "float32"):
            row[f"bound_ms_{rate}"], row[f"bound_by_{rate}"] = _ssd_bound(
                b, l, SSD_H, SSD_P, SSD_N, Q, 2, rate)
        if not times:
            row["plain_ms"] = timer(torch, lambda i: ref.ssd_scan_ref(
                x, dt, A, B, C), iters=3, warmup=1)
        times[f"b={b} l={l}"] = row
    # zamba2-7b's width on its served prefill
    b, l = SSD_ZAMBA_TIMED
    h, p, n = SSD_ZAMBA
    x, dt, A, B, C = _ssd_inputs(torch, b, l, torch.bfloat16, seed=8,
                                 dev=dev, h=h, p=p, n=n)
    Q = min(SSD_CHUNK, l)
    row = {"ms": timer(torch, lambda i: ssd.ssd_scan(
        x, dt, A, B, C, chunk=SSD_CHUNK)),
        "chunked_path_ms": timer(torch, lambda i: ssm.ssd_chunked(
            x, dt, A, B, C, SSD_CHUNK), iters=5, warmup=1),
        "plain_ms": timer(torch, lambda i: ref.ssd_scan_ref(
            x, dt, A, B, C), iters=3, warmup=1),
        "ops": _ssd_ops(b, l, h, p, n, Q)}
    for rate in ("bfloat16", "float32"):
        row[f"bound_ms_{rate}"], row[f"bound_by_{rate}"] = _ssd_bound(
            b, l, h, p, n, Q, 2, rate)
    times[f"zamba2 b={b} l={l} h={h} p={p} n={n}"] = row
    del x, dt, B, C
    first = next(iter(times.values()))
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:69",
        "max_abs_err": worst, "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms_bfloat16"],
        "bound_by": first["bound_by_bfloat16"], "library_ms": None,
    }, {"errors": errs,
        "tolerance": f"{SSD_F32_REL} x max |y| (float32); plus one bf16 "
        f"step ({SSD_BF16_STEP} x |y|) for a bf16 y",
        "broken_moves_share_of_max_y": moves,
        "row_shape": f"b=4 l=1024 h={SSD_H} p={SSD_P} n={SSD_N} "
        f"chunk={SSD_CHUNK}, bf16 x/B/C as strided views",
        "timed": times,
        "bound_note": "the row's bound is at the bf16 tensor-core rate, "
        "where the bf16 instantiation runs its products; bound_ms_float32 "
        "is a scan on the CUDA cores",
        "plain": "ref.ssd_scan_ref, the sequential recurrence",
        "library_call": "none: no single PyTorch call computes the scan",
        "ptxas_bf16": _ptxas_bf16(ssd.NAME)}


# ---------------------------------------------------------------------------
# phase 3: flash_attention against its plain version
# ---------------------------------------------------------------------------

def _flash_inputs(torch, B, S, T, H, K, hd, dtype, *, seed=0, dev="cuda"):
    """q at 3 x randn, k and v at 0.5 x randn: each softmax is peaked,
    so a key seen or missed moves the output far past the tolerances."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g) * 3.0
    k = torch.randn((B, T, K, hd), generator=g) * 0.5
    v = torch.randn((B, T, K, hd), generator=g) * 0.5
    return tuple(t.to(dtype).to(dev) for t in (q, k, v))


def _flash_pairs(S: int, T: int, window: int) -> int:
    """Visible (query, key) pairs of one (row, head): key j <= i (and
    j > i - window), j < T."""
    total = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        total += max(0, min(i, T - 1) - lo + 1)
    return total


def _flash_bound(B, S, T, H, K, hd, window, elt: int, rate: str):
    """Least time (ms) of one call: q, k, v read once and the output
    written once, against 4 hd operations (q.k and p.v) per visible pair
    and query head at the peak rate of ``rate``."""
    nbytes = (2 * B * S * H * hd + 2 * B * T * K * hd) * elt
    ops = 4 * hd * H * B * _flash_pairs(S, T, window)
    return _roofline(nbytes, ops, rate) + (ops,)


def _flash_shifted(torch, q, k, v, scale, window):
    """A broken kernel: the causal mask one key late (query i also sees
    key i + 1, and the window moves with it), in float32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None] + 1
    j = torch.arange(T, device=q.device)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.float()).reshape(q.shape)


def check_flash_attention(torch, fa, ref, timer, dev="cuda"):
    """Hold the kernel against its plain version computed in float64 on
    the same inputs (the float32 plain version's own summation errors
    reach the bf16 tolerance in near-tie rows at scale 1:
    ``exact_misses_float32_plain`` counts the outputs where even the
    exact result, rounded to the kernel's dtype, misses it) at the
    evaluation path's shape, window 0 and 512, and beside it (phi3's
    GQA, a ragged S, T < S and T > S), bf16 and f32;
    a softcap of 50 at scale 1 must bind; two broken versions (window
    ignored, causal mask one key late) must land far outside the
    tolerance; the window-512 launch must take under FLASH_BAND_SHARE of
    the global launch's time.  Times the kernel, the plain version and
    SDPA at the path's shape, next to the bound."""
    import torch.nn.functional as F
    errs, worst, errs_f32, exact_misses = {}, 0.0, {}, {}

    def held(case, q, k, v, **kw):
        nonlocal worst
        out = fa.flash_attention(q, k, v, **kw)
        _sync(torch)
        exp = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                      **kw)
        tol = TOL[str(q.dtype).replace("torch.", "")]
        err = float((out.double() - exp).abs().max())
        if out.dtype != q.dtype or not torch.allclose(out.double(), exp,
                                                      **tol):
            raise AssertionError(f"flash_attention {case}: max abs err {err} "
                                 f"beyond tolerance {tol}")
        plain = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        errs_f32[case] = float((out.float() - plain).abs().max())
        exact_misses[case] = int((~torch.isclose(
            exp.to(q.dtype).float(), plain, **tol)).sum())
        errs[case] = err
        worst = max(worst, err)
        return out.float(), exp.float()

    for seed, (name, B, S, T, H, K, hd, w) in enumerate(FLASH_CASES):
        for dt in ("bfloat16", "float32"):
            q, k, v = _flash_inputs(torch, B, S, T, H, K, hd,
                                    getattr(torch, dt), seed=seed, dev=dev)
            held(f"{name} {dt}", q, k, v, scale=hd ** -0.5, window=w)
    q, k, v = _flash_inputs(torch, 2, 1024, 1024, 4, 1, 256, torch.bfloat16,
                            seed=20, dev=dev)
    capped, _ = held("softcap50/scale1", q, k, v, scale=1.0,
                     window=FLASH_WINDOW, softcap=50.0)
    free, _ = held("softcap0/scale1", q, k, v, scale=1.0,
                   window=FLASH_WINDOW)
    cap_moves = float((capped - free).abs().max())
    if cap_moves <= CAP_MOVES:
        raise AssertionError(f"flash_attention: softcap 50 moved the output "
                             f"by only {cap_moves}")

    # broken versions at the path's local launch, from the plain version
    B, S, T, H, K, hd = FLASH_PATH
    scale = hd ** -0.5
    q, k, v = _flash_inputs(torch, B, S, T, H, K, hd, torch.bfloat16,
                            seed=21, dev=dev)
    got, want = held("path local bf16 (broken check)", q, k, v, scale=scale,
                     window=FLASH_WINDOW)
    broken = {"window_ignored": ref.flash_attention_ref(
                  q.float(), k.float(), v.float(), scale=scale),
              "mask_one_key_late": _flash_shifted(torch, q, k, v, scale,
                                                  FLASH_WINDOW)}
    moves = {n: float((b - want).abs().max()) for n, b in broken.items()}
    for n, b in broken.items():
        if moves[n] <= CAP_MOVES or torch.allclose(b, want,
                                                   **TOL["bfloat16"]):
            raise AssertionError(f"flash_attention: the broken version {n} "
                                 f"moves the output by only {moves[n]}")
    del broken, got, want

    # times at the path's shape, bf16 as the evaluation runs
    times = {}
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    for w in (0, FLASH_WINDOW):
        ms = timer(torch, lambda i, w=w: fa.flash_attention(
            q, k, v, scale=scale, window=w))
        plain_ms = timer(torch, lambda i, w=w: ref.flash_attention_ref(
            q, k, v, scale=scale, window=w), iters=10, warmup=2)
        if w:
            i_ = torch.arange(S, device=q.device)[:, None]
            j_ = torch.arange(T, device=q.device)[None, :]
            mask = (j_ <= i_) & (j_ > i_ - w)
            lib_kw = dict(attn_mask=mask)
        else:
            lib_kw = dict(is_causal=True)
        library_ms = timer(torch, lambda i, kw=lib_kw: (
            F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                           enable_gqa=True, **kw)))
        bound_ms, bound_by, ops = _flash_bound(B, S, T, H, K, hd, w, 2,
                                               "bfloat16")
        f32_ms, f32_by, _ = _flash_bound(B, S, T, H, K, hd, w, 2, "float32")
        times["global" if w == 0 else "local"] = {
            "window": w, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ops": ops,
            "bound_float32_rate_ms": f32_ms, "bound_float32_rate_by": f32_by}
    lib = F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                         enable_gqa=True, is_causal=True)
    lib_err = float((lib.transpose(1, 2).float() - ref.flash_attention_ref(
        q.float(), k.float(), v.float(), scale=scale)).abs().max())
    del lib, qt, kt, vt

    # zamba2-7b's admission prefill: 32 heads over 32 kv heads of 112
    # (the 128-wide instantiation), causal, bf16
    hB, hS, hT, hH, hK, hhd = FLASH_HYBRID
    hq, hk, hv = _flash_inputs(torch, *FLASH_HYBRID, torch.bfloat16,
                               seed=22, dev=dev)
    hscale = hhd ** -0.5
    hqt, hkt, hvt = (t.transpose(1, 2).contiguous() for t in (hq, hk, hv))
    bound_ms, bound_by, ops = _flash_bound(*FLASH_HYBRID, 0, 2, "bfloat16")
    times["zamba2 prefill"] = {
        "shape": f"B={hB} S=T={hS} H={hH} K={hK} hd={hhd} bf16 causal",
        "ms": timer(torch, lambda i: fa.flash_attention(
            hq, hk, hv, scale=hscale)),
        "plain_ms": timer(torch, lambda i: ref.flash_attention_ref(
            hq, hk, hv, scale=hscale), iters=10, warmup=2),
        "library_ms": timer(torch, lambda i: F.scaled_dot_product_attention(
            hqt, hkt, hvt, scale=hscale, is_causal=True)),
        "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops}
    del hq, hk, hv, hqt, hkt, hvt
    share = times["local"]["ms"] / times["global"]["ms"]
    if share >= FLASH_BAND_SHARE:
        raise AssertionError(f"flash_attention: the window-512 launch takes "
                             f"{share} of the global launch's time (band "
                             f"skipping must keep it under "
                             f"{FLASH_BAND_SHARE})")
    row = times["global"]
    from repro_torch.kernels import build
    log = build.library_path("flash_attention").with_suffix(".log")
    ptxas = ptxas_report(log, "mma_kernel") if log.exists() else {}
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:366",
        "max_abs_err": worst, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }, {"errors": errs, "tolerance": TOL,
        "reference": "ref.flash_attention_ref on float64 copies",
        "errors_vs_float32_plain": errs_f32,
        "exact_misses_float32_plain": exact_misses,
        "softcap50_moves": cap_moves,
        "broken_moves": moves, "timed": times,
        "local_over_global_time": share,
        "local_over_global_work": times["local"]["ops"] / row["ops"],
        "row_shape": "B=2 S=T=4096 H=4 K=1 hd=256 bf16, window 0 (the "
        "global layers; the local window-512 launch under timed.local)",
        "library_call": "F.scaled_dot_product_attention(enable_gqa=True), "
        "is_causal for window 0, a boolean band mask for window 512",
        "library_max_abs_err": lib_err, "ptxas_bf16_kernel": ptxas}


# ---------------------------------------------------------------------------
# phases 4-14
# ---------------------------------------------------------------------------

def serve_phase(torch, kernels, serve, scale="full", dev="cuda"):
    """Drive the first main path (bf16 pool); returns (engine, cfg,
    phase fields).  ``kernels`` maps each kernel's name to its wrapper
    module (with its ``launches`` counter)."""
    clock = serve.default_clock
    t0 = clock()
    cfg, eng = serve.build_engine(ARCH, scale, dict(SERVE,
                                                    prefix_cache=False),
                                  dev)
    init_s = clock() - t0
    L = cfg.num_layers
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_attention": L * eng.decode_waves,
        "paged_extend_attention": 0, "quant_matmul": 0, "ssd_scan": 0},
        needs=("paged_attention",))
    fields["init_s"] = init_s
    return eng, cfg, fields


def serve_int8_phase(torch, kernels, serve, eng0, cfg):
    """Drive the second main path: the first engine's model and traffic
    on an int8 pool; returns (engine, phase fields)."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    eng = EdgeServingEngine(cfg, eng0.params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, quant_kv="int8",
        **SERVE), device=eng0.device)
    L = cfg.num_layers
    return eng, _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_attention": L * eng.decode_waves,
        "paged_extend_attention": L * eng.extend_waves, "quant_matmul": 0,
        "ssd_scan": 0},
        needs=("paged_attention", "paged_extend_attention"))


def serve_dense_phase(torch, kernels, serve, params, cfg, serve_tokens,
                      dev="cuda"):
    """The dense twin: the first path's model, weights and traffic with
    ``paged=False`` (``max_len`` strips per slot and layer, no pool): every
    request finishes, no kernel launches (``use_pallas_paged`` reads no
    page, as in JAX), and the tokens meet the int8 gate against the
    ``serve`` phase's (``serve_tokens``; strips and pages are read by
    other code, a near-tie may flip at bf16)."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        paged=False, use_pallas_paged=True, **SERVE), device=dev)
    if eng.paged or eng.pool is not None or eng.prefix_cache is not None:
        raise AssertionError("serve_dense: the dense twin has a page pool")
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {}, needs=())
    tokens = {r.uid: list(r.generated) for r in eng.completed}
    first, lcp, total = _int8_gate(tokens, serve_tokens)
    fields.update(
        kv_pool="none (dense strips)",
        strip_gb=sum(t.numel() * t.element_size() for t in (
            eng.cache["layers"]["k"], eng.cache["layers"]["v"])) / 1e9,
        serve_first_tokens_equal=f"{first}/{len(serve_tokens)}",
        serve_lcp_share=lcp / total, serve_tokens_equal=tokens == serve_tokens)
    if first != len(serve_tokens) or lcp < INT8_LCP_SHARE * total:
        raise AssertionError(f"serve_dense: first tokens {first}/"
                             f"{len(serve_tokens)}, LCP {lcp}/{total}")
    return fields


def _shared_requests(cfg, request_cls) -> list:
    """The eighth path's household traffic (``SHARED_*``), fresh requests
    from seed 0: one system prompt, one persona, each user's own tail."""
    import numpy as np
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    sys_prompt = rng.integers(0, V, SHARED_SYS, dtype=np.int32)
    persona = rng.integers(0, V, SHARED_PERSONA, dtype=np.int32)
    reqs = []
    for uid in range(SHARED_USERS):
        n = int(rng.integers(SHARED_TAIL[0], SHARED_TAIL[1] + 1))
        tail = rng.integers(0, V, n, dtype=np.int32)
        reqs.append(request_cls(uid=uid, max_new_tokens=SHARED_NEW,
                                prompt=np.concatenate([sys_prompt, persona,
                                                       tail])))
    return reqs


def _shared_drive(torch, kernels, serve, eng, reqs) -> dict:
    """User 0 alone until its first token (its chain publishes in flight),
    then users 1-7 together, until the engine drains; the kernel counts
    zeroed just before and read just after.  Each step ends with the
    wave's tokens on the host, so host stamps bound the work."""
    clock = serve.default_clock
    t_sub, ttft = {}, {}
    waves = (eng.decode_waves, eng.extend_waves, eng.steps)

    def submit(rs):
        for r in rs:
            eng.submit(r)
            t_sub[r.uid] = clock()

    def step():
        eng.drain_step()
        now = clock()
        for r in reqs:
            if r.uid not in ttft and r.generated:
                ttft[r.uid] = (now - t_sub[r.uid]) * 1e3
    _zero(kernels)
    t0 = clock()
    submit(reqs[:1])
    while not reqs[0].generated:
        step()
    submit(reqs[1:])
    while eng.queue or eng.active.any():
        step()
    elapsed = clock() - t0
    launches = _counts(kernels)
    decode, extend, steps = (a - b for a, b in zip(
        (eng.decode_waves, eng.extend_waves, eng.steps), waves))
    if len(eng.completed) < len(reqs) or any(
            len(r.generated) != r.max_new_tokens for r in reqs):
        raise AssertionError("serve_shared: requests unfinished")
    hits = sorted(ttft[u] for u in ttft if u != reqs[0].uid)
    return {"launches": launches, "decode_waves": decode,
            "extend_waves": extend, "steps": steps, "elapsed_s": elapsed,
            "tokens": sum(len(r.generated) for r in reqs),
            "tok_per_s": sum(len(r.generated) for r in reqs) / elapsed,
            "ms_per_step": elapsed * 1e3 / steps,
            "ttft_user0_ms": ttft[reqs[0].uid],
            "ttft_users1_7_p50_ms": hits[len(hits) // 2]}


def _shared_wave_ms(torch, M, eng, cfg, dev) -> dict:
    """Shared pages against private ones at position 400 (26 pages a
    row), 4 rows: the decode read alone (``paged_attention`` on layer 0's
    pool, device ms of calls back to back) and one kernel decode wave's
    device-busy ms (profiled), with tables whose first 13 pages are the
    same in every row (a shared system prompt) and with 4 x 26 distinct
    pages.  Contents are whatever the pool holds: only times are read."""
    from repro_torch.kernels import ops
    B, n = 4, 26
    shared = torch.full((B, eng.n_blk), -1, dtype=torch.int32)
    private = shared.clone()
    for b in range(B):
        private[b, :n] = torch.arange(b * n, (b + 1) * n)
        shared[b, :13] = torch.arange(13)
        shared[b, 13:n] = torch.arange(13 + b * 13, 26 + b * 13)
    pos = torch.full((B,), 400, dtype=torch.int32, device=dev)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pool = eng.cache["layers"]
    q = torch.randn((B, cfg.num_heads, cfg.head_dim),
                    generator=torch.Generator().manual_seed(3)).to(
                        device=dev, dtype=pool["k"].dtype)
    out = {}
    for name, bt in (("shared", shared), ("private", private)):
        bt = bt.to(dev)
        out[f"paged_attention_{name}_pages_ms"] = cuda_ms(
            torch, lambda i: ops.paged_attention(
                q, pool["k"][0], pool["v"][0], bt, pos + 1,
                scale=cfg.head_dim ** -0.5))
        prof = _device_profile(torch, lambda: M.decode_step_paged(
            cfg, eng.params, eng.cache, tok, pos, bt, True))
        out[f"decode_wave_{name}_pages_busy_ms"] = prof.get(
            "device_busy_ms", "not measured")
    return out


def serve_shared_phase(torch, kernels, serve, M, params, cfg, dev="cuda"):
    """Drive the eighth main path, on a bf16 and on an int8 pool: the
    household traffic through ``ServeConfig``'s defaults (the radix
    prefix cache on) with the hand-written reads.  Each leg: 7 hits and 1
    miss, hits past the page boundary (token-granular, a copy-on-write
    fork of the system prompt's partial page), ``paged_attention`` on
    every layer of every decode wave and, on int8 pages,
    ``paged_extend_attention`` on every layer of every (catch-up) extend
    wave, no page leaked, and the hit rows' tokens held by the int8 gate
    to the same requests served cold (``prefix_cache=False``, same
    weights and order) — on the int8 leg, the first tokens and an LCP no
    shorter than the int8 cold run's against the bf16 cold run's (see
    the comment at the check).  The bf16 leg then serves user 1 again (a hit on
    its own chain), writes the cache to a store (``close()``), builds a
    fresh engine from it and serves user 1 once more: one hit, the live
    re-serve's tokens exactly.  Returns the phase fields; ``launches`` sum
    the two legs' prefix-cache runs."""
    from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
    full = cfg.num_layers
    cfg, params = _depth_cut(cfg, params, SHARED_DEPTH)
    L = cfg.num_layers
    fields = {"arch": cfg.name, "depth": L,
              "depth_cut": f"{L} of {full} layers (the script's time)",
              "users": SHARED_USERS,
              "system_prompt_tokens": SHARED_SYS,
              "persona_tokens": SHARED_PERSONA,
              "own_tokens": list(SHARED_TAIL), "new_tokens": SHARED_NEW,
              "launches": dict.fromkeys(kernels, 0)}
    cold_tok = {}
    for leg, quant in (("bf16", None), ("int8", "int8")):
        persist = leg == "bf16"
        store = str(SHARED_STORE) if persist else None
        if persist and SHARED_STORE.exists():
            SHARED_STORE.unlink()
        kw = dict(SHARED_SERVE, quant_kv=quant)
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            **kw, prefix_persist_path=store), device=dev)
        if not (eng.sharable and eng.paged):
            raise AssertionError(f"serve_shared {leg}: the cache is off")
        cuda = eng.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reqs = _shared_requests(cfg, Request)
        run = _shared_drive(torch, kernels, serve, eng, reqs)
        run["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if cuda else None)
        st = eng.stats()
        expect = dict.fromkeys(kernels, 0)
        expect.update(paged_attention=L * run["decode_waves"],
                      paged_extend_attention=(L * run["extend_waves"]
                                              if quant else 0))
        run.update({k: st[f"prefix_{k}"] for k in (
            "hits", "misses", "hit_tokens", "hit_tokens_block",
            "hit_blocks", "cached_blocks")})
        run.update(cow_forks=st["cow_forks"],
                   published_frontiers=st["published_frontiers"],
                   prefill_tokens_saved=st["prefix_hit_tokens"],
                   prompt_tokens=sum(len(r.prompt) for r in reqs))
        if (run["launches"] != expect or run["decode_waves"] == 0
                or (quant and run["extend_waves"] == 0)):
            raise AssertionError(f"serve_shared {leg}: launches "
                                 f"{run['launches']}, expected {expect}")
        if (run["hits"], run["misses"]) != (SHARED_USERS - 1, 1) or \
                run["hit_tokens"] <= run["hit_tokens_block"] or \
                run["cow_forks"] < 1:
            raise AssertionError(f"serve_shared {leg}: {st}")
        _check_pool(eng, f"serve_shared {leg}")
        for name, n in run["launches"].items():
            fields["launches"][name] += n

        cold_eng = EdgeServingEngine(cfg, params, ServeConfig(
            **kw, prefix_cache=False), device=dev)
        cold_reqs = _shared_requests(cfg, Request)
        cold = _shared_drive(torch, kernels, serve, cold_eng, cold_reqs)
        _check_pool(cold_eng, f"serve_shared {leg} cold")
        del cold_eng
        hot_tok = {r.uid: list(r.generated) for r in reqs[1:]}
        cold_tok[leg] = {r.uid: list(r.generated) for r in cold_reqs[1:]}
        first, lcp, total = _int8_gate(hot_tok, cold_tok[leg])
        run.update(cold={k: cold[k] for k in (
            "tok_per_s", "ms_per_step", "ttft_user0_ms",
            "ttft_users1_7_p50_ms", "steps", "decode_waves",
            "extend_waves")},
            hit_first_tokens_equal_cold=f"{first}/{total // SHARED_NEW}",
            hit_lcp_share_cold=lcp / total,
            hit_tokens_equal_cold=hot_tok == cold_tok[leg])
        # the bf16 leg: the int8 gate.  The int8 leg: every first token
        # (the hit prefill's own output) equal, and the hit rows may
        # drift from the cold rows no faster than int8 pages alone move
        # the cold rows off the bf16 pool's (the LCP of the cold runs of
        # the two legs): a hit reads its context as int8 from its first
        # token on, the cold prefill reads exact K/V, and at this size
        # random weights leave near-tied logits that either perturbation
        # flips (PERF.md, section 6)
        floor = INT8_LCP_SHARE * total
        if quant:
            ctl = _int8_gate(cold_tok[leg], cold_tok["bf16"])[1]
            run["control_lcp_share_int8_cold_vs_bf16_cold"] = ctl / total
            floor = ctl
        if first != total // SHARED_NEW or lcp < floor:
            raise AssertionError(f"serve_shared {leg}: hit rows against "
                                 f"cold: first {first}, LCP {lcp}/{total}"
                                 f" (at least {floor})")

        if persist:
            again = Request(uid=101, prompt=reqs[1].prompt.copy(),
                            max_new_tokens=SHARED_NEW)
            h0 = eng.prefix_cache.hits
            eng.submit(again)
            eng.run_until_drained()
            reserve_hits = eng.prefix_cache.hits - h0
            saved = eng.close()
            run.update(_shared_wave_ms(torch, M, eng, cfg, dev))
            del eng
            _release(torch)
            warm = EdgeServingEngine(cfg, params, ServeConfig(
                **kw, prefix_persist_path=store), device=dev)
            replay = Request(uid=201, prompt=reqs[1].prompt.copy(),
                             max_new_tokens=SHARED_NEW)
            clock = serve.default_clock
            t0 = clock()
            warm.submit(replay)
            ttft = None
            while warm.queue or warm.active.any():
                warm.drain_step()
                if ttft is None and replay.generated:
                    ttft = (clock() - t0) * 1e3
            _check_pool(warm, "serve_shared restart")
            run["restart"] = {
                "store_bytes": os.path.getsize(store),
                "saved_chains": saved["persist_saved_chains"],
                "saved_blocks": saved["persist_saved_blocks"],
                "loaded_chains": warm.persist_loaded_chains,
                "loaded_blocks": warm.persist_loaded_blocks,
                "rejected": warm.persist_rejected,
                "hits": warm.prefix_cache.hits,
                "live_reserve_hits": reserve_hits,
                "ttft_ms": ttft,
                "tokens_equal_live": replay.generated == again.generated,
                "tokens_equal_first_serve": (replay.generated
                                             == reqs[1].generated)}
            if (warm.persist_rejected or warm.prefix_cache.hits != 1
                    or reserve_hits != 1
                    or replay.generated != again.generated):
                raise AssertionError(f"serve_shared restart: "
                                     f"{run['restart']}")
            del warm
            SHARED_STORE.unlink()
        else:
            del eng
        _release(torch)
        fields[leg] = run
    return fields


def _drive(torch, kernels, serve, eng, cfg, expected, needs,
           traffic=(N_REQ, MIN_PROMPT, MAX_PROMPT, MAX_NEW)):
    """Serve the phase's traffic (requests, shortest and longest prompt,
    new tokens) through ``eng`` with every kernel count zeroed just
    before and read just after; check the output, that each kernel made
    exactly the launches ``expected()`` gives after the run (one per
    layer of each wave or prefill that goes through it), and that every
    kernel of ``needs`` — the phase's path — launched at all."""
    dev = eng.device
    n_req, _, _, max_new = traffic
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reqs = serve.make_requests(cfg, *traffic, eng.scfg.policy)
    _zero(kernels)
    raw = serve.run_drain(eng, reqs)
    launches = _counts(kernels)
    done = eng.completed
    if len(done) != n_req or any(len(r.generated) != max_new for r in done):
        raise AssertionError(f"serve: {len(done)} requests done, lengths "
                             f"{[len(r.generated) for r in done]}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("serve: token id outside the vocabulary")
    expect = dict.fromkeys(kernels, 0)
    expect.update(expected())
    if launches != expect or any(launches[n] == 0 for n in needs):
        raise AssertionError(
            f"serve: kernel launches {launches} for {eng.decode_waves} "
            f"decode and {eng.extend_waves} extend waves x "
            f"{cfg.num_layers} layers (expected {expect}, none 0 of "
            f"{needs})")
    _check_pool(eng, "serve")
    ttft = raw["ttft_ms"]
    return {
        "arch": cfg.name, "depth": cfg.num_layers, "depth_cut": False,
        "d_model": cfg.d_model, "params": cfg.param_count(),
        "param_dtype": cfg.param_dtype,
        "kv_pool": (str(_pool(eng)["k"].dtype).replace("torch.", "")
                    if eng.paged else "none (pool-free)"),
        "requests": raw["requests"], "tokens": raw["tokens"],
        "steps": raw["decode_steps"], "decode_waves": eng.decode_waves,
        "extend_waves": eng.extend_waves, "elapsed_s": raw["elapsed_s"],
        "tok_per_s": raw["tok_per_s"],
        "ms_per_step": raw["elapsed_s"] * 1e3 / raw["decode_steps"],
        "ttft_p50_ms": ttft[len(ttft) // 2],
        "ttft_p99_ms": ttft[min(len(ttft) - 1, int(0.99 * len(ttft)))],
        "prompt_lengths": [len(r.prompt) for r in reqs],
        "launches": launches,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if dev.type == "cuda" else None),
    }


def _check_pool(eng, phase: str) -> None:
    """After a drain every page is free or held by the radix cache (with
    the cache off: every page is free)."""
    if not eng.paged:
        return
    eng.pool.assert_consistent()
    cached = eng.prefix_cache.num_blocks if eng.prefix_cache else 0
    if eng.pool.num_free + cached != eng.pool.num_blocks:
        raise AssertionError(f"{phase}: {eng.pool.num_used - cached} pages "
                             f"leaked ({cached} held by the prefix cache)")


def _pool(eng) -> dict:
    """The engine's page pool: every layer's on a uniform trunk, the moe
    layers' on a moe trunk, the decoder's self attention on an encdec
    cache, the global layers' on a local:global pattern."""
    cache = eng.cache
    for key in ("layers", "moe_layers", "self"):
        if key in cache:
            return cache[key]
    return cache["super"]["global"]


def _device_profile(torch, fn) -> dict:
    """One profiled call of ``fn``: wall ms, device-busy ms (sum of the
    kernels' own times), idle share, and the top ops by device time.
    Busy time sums the device events only: an operator's row repeats the
    time of the kernels it launched, so summing every row counts each
    kernel twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = _clock_ms()
        fn()
        torch.cuda.synchronize()
        wall = _clock_ms() - t0

    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))
    evs = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in evs if e.device_type != DeviceType.CPU) \
        / 1e3
    if busy <= 0:
        return {"wall_ms": wall, "device_ms": "not measured"}
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "top_ops_device_ms": {e.key: dev_us(e) / 1e3 for e in evs[:10]}}


def model_phase(torch, M, eng, cfg, dev="cuda"):
    """Kernel read vs gather read of ``decode_step_paged`` from one cache
    state (the served pool's pages), one decode wave's time each, and
    where a decode wave's time goes.

    Held at float32 activations first (both reads then differ only in
    summation order: within F32_REL_TOL of max |logit|), then at the
    serving bf16 activations, where the gather path also rounds its
    softmax probabilities to bf16 (within BF16_REL_TOL); both bf16
    reads are reported against the float32 logits."""
    B = 4
    lengths, bt, pos, tok = _wave_state(torch, eng, cfg, 1, dev)
    cfg32 = cfg.replace(dtype="float32")

    def logits(c, use_kernel):
        out, _ = M.decode_step_paged(c, eng.params, eng.cache, tok, pos, bt,
                                     use_kernel)
        out = out[:, 0].float()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("model: non-finite logits")
        return out

    ref32, ker32 = logits(cfg32, False), logits(cfg32, True)
    ker16, gat16 = logits(cfg, True), logits(cfg, False)
    scale = float(ref32.abs().max())

    def dmax(a, b):
        return float((a - b).abs().max())
    d32, d16 = dmax(ker32, ref32), dmax(ker16, gat16)
    if d32 > F32_REL_TOL * scale:
        raise AssertionError(f"model: float32 kernel vs gather logits "
                             f"differ by {d32} (max |logit| {scale})")
    if d16 > BF16_REL_TOL * scale:
        raise AssertionError(f"model: bf16 kernel vs gather logits differ "
                             f"by {d16} (max |logit| {scale})")

    def agree(a, b):
        return f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{B}"
    wave = {k: cuda_ms(torch, lambda i, k=k: M.decode_step_paged(
        cfg, eng.params, eng.cache, tok, pos, bt, k), iters=10, warmup=2)
        for k in (True, False)}
    prof = _device_profile(torch, lambda: M.decode_step_paged(
        cfg, eng.params, eng.cache, tok, pos, bt, True))
    return {"lengths": lengths, "max_abs_logit_f32": scale,
            "f32_kernel_vs_gather": d32, "f32_tolerance":
            f"{F32_REL_TOL} x max |logit|",
            "bf16_kernel_vs_gather": d16, "bf16_tolerance":
            f"{BF16_REL_TOL} x max |logit|",
            "bf16_kernel_vs_f32": dmax(ker16, ref32),
            "bf16_gather_vs_f32": dmax(gat16, ref32),
            "argmax_agree_bf16_kernel_gather": agree(ker16, gat16),
            "argmax_agree_bf16_kernel_f32": agree(ker16, ref32),
            "decode_wave_ms_kernel": wave[True],
            "decode_wave_ms_gather": wave[False],
            "decode_wave_profile": prof}


def _wave_state(torch, eng, cfg, S, dev):
    """Block tables, positions and tokens of one 4-slot wave over the
    engine's pool: rows at positions 300, 211, 97, 33 with tables
    covering them and S more tokens (pages of the served pool)."""
    B, bs = 4, eng.block_size
    lengths = [300, 211, 97, 33]
    bt = torch.full((B, eng.n_blk), -1, dtype=torch.int32)
    for b, n in enumerate(lengths):
        k = -(-(n + S) // bs)
        bt[b, :k] = torch.arange(b * eng.n_blk, b * eng.n_blk + k)
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(5)).to(dev)
    return lengths, bt.to(dev), pos, tok


def _layerwise_blocks(torch, cfg, params, cache, tokens, block):
    """Run the trunk block by block through the gather read and, at
    every layer, the same block through the kernel read on the same
    input and a copy of the same pool: the two outputs then differ in
    summation order only.  Returns the largest per-layer max |kernel -
    gather| and whether every layer's pair is within TOL["float32"]."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    x = L.embed(cfg, params["embed"], tokens)
    worst, ok = 0.0, True
    for lp, pool in M.paged_layers(cfg, params, cache):
        shadow = {k: v.clone() for k, v in pool.items()}
        ker, _ = block(lp, x, shadow, True)
        x, _ = block(lp, x, pool, False)
        worst = max(worst, float((ker - x).abs().max()))
        ok = ok and bool(torch.allclose(ker, x, **TOL["float32"]))
    return worst, ok


def model_int8_phase(torch, M, eng, cfg, dev="cuda"):
    """On the int8 pool of the served model, kernel reads against gather
    reads at float32 activations, for decode and for extend.

    Every layer is held on identical inputs: the trunk runs through the
    gather read, and each block also runs through the kernel read on the
    same input and a copy of the same pool; the outputs must agree within
    TOL["float32"].  This takes the place of holding two full-model runs'
    logits within F32_REL_TOL x max |logit|: each run quantizes the K/V
    it writes, so float noise between the runs moves some written bytes
    by one int8 level (a step of max |k| / 127, far above float32
    rounding), and the step travels on through the later layers.  The
    two runs' logits are reported beside the count of written bytes that
    differ, and their greedy tokens must agree.  Times one extend and
    one decode wave of each read at the serving bf16 activations."""
    from repro_torch.models import transformer as T
    S = eng.K
    lengths, bt, pos, tok = _wave_state(torch, eng, cfg, S, dev)
    cfg32 = cfg.replace(dtype="float32")
    pool = eng.cache["layers"]
    runs = {
        "decode": (tok[:, :1], lambda c, k: M.decode_step_paged(
            c, eng.params, eng.cache, tok[:, :1], pos, bt, k)[0][:, 0],
            lambda lp, x, pg, k: T.block_decode_paged(cfg32, lp, x, pg, pos,
                                                      bt, k)),
        "extend": (tok, lambda c, k: M.extend_paged(
            c, eng.params, eng.cache, tok, pos, bt, None, k)[0],
            lambda lp, x, pg, k: T.block_extend_paged(
                cfg32, lp, x, pos, pg, bt, None, use_pallas=k)),
    }
    res = {"lengths": lengths, "extend_tokens": S,
           "layer_tolerance": TOL["float32"],
           "logits": "reported, not held: see the written bytes that differ"}
    for name, (tokens, full, block) in runs.items():
        layer_err, layer_ok = _layerwise_blocks(torch, cfg32, eng.params,
                                                eng.cache, tokens, block)
        if not layer_ok:
            raise AssertionError(f"model_int8: {name} kernel read differs "
                                 f"from the gather read on identical "
                                 f"inputs by {layer_err}")
        ker = full(cfg32, True).float()
        written = {k: pool[k].clone() for k in ("k", "v")}
        gat = full(cfg32, False).float()
        if not bool(torch.isfinite(ker).all() and torch.isfinite(gat).all()):
            raise AssertionError(f"model_int8: non-finite {name} logits")
        differ = sum(int((pool[k] != written[k]).sum()) for k in written)
        del written
        same = int((ker.argmax(-1) == gat.argmax(-1)).sum())
        total = ker.argmax(-1).numel()
        res.update({f"{name}_layerwise_max_abs_err": layer_err,
                    f"{name}_max_abs_logit_f32": float(gat.abs().max()),
                    f"{name}_f32_kernel_vs_gather":
                        float((ker - gat).abs().max()),
                    f"{name}_written_bytes_differ": differ,
                    f"{name}_argmax_agree_f32": f"{same}/{total}"})
        if same != total:
            raise AssertionError(f"model_int8: {name} greedy tokens agree "
                                 f"{same}/{total}")
    for name, call in (
            ("extend", lambda k: M.extend_paged(cfg, eng.params, eng.cache,
                                                tok, pos, bt, None, k)),
            ("decode", lambda k: M.decode_step_paged(
                cfg, eng.params, eng.cache, tok[:, :1], pos, bt, k))):
        for k in (True, False):
            res[f"{name}_wave_ms_{'kernel' if k else 'gather'}"] = cuda_ms(
                torch, lambda i, k=k, call=call: call(k), iters=10,
                warmup=2)
    res["extend_wave_profile"] = _device_profile(torch, lambda: M.extend_paged(
        cfg, eng.params, eng.cache, tok, pos, bt, None, True))
    return res


def _tree(fn, tree):
    return {k: (_tree(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _depth_cut(cfg, params, n: int):
    """The first ``n`` trunk layers of the stacked trunk, as views (no
    copy), with everything else by reference."""
    cut = dict(params)
    cut["trunk"] = {"layers": _tree(lambda t: t[:n],
                                    params["trunk"]["layers"])}
    return cfg.replace(num_layers=n), cut


def make_draft(cfg, params, n: int):
    """The explicit draft of the speculative phases: the verify model's
    first ``n`` trunk layers, copied out of the stacked trunk, its
    embedding and unembedding by reference, and an early-exit norm as
    the final norm (``core.earlyexit.init_exit_heads``).  Built here, not
    in the package: the engine refuses ``quant_draft`` for the
    by-reference self-draft, and quantizing a reference to the whole
    trunk would make an int8 copy of all of it."""
    from repro_torch.core.earlyexit import init_exit_heads
    from repro_torch.devices import tensor_device
    dparams = dict(params)
    dparams["trunk"] = {"layers": _tree(lambda t: t[:n].clone(),
                                        params["trunk"]["layers"])}
    dparams["final_norm"] = init_exit_heads(
        cfg, [n - 1], device=tensor_device(params))["exits"][0]["ln"]
    return cfg.replace(num_layers=n, name=f"{cfg.name}-draft{n}"), dparams


def _count_calls(obj, names, counter: dict) -> None:
    """Wrap the methods ``names`` of ``obj`` (on the instance) so each
    call adds one to ``counter[name]``."""
    for name in names:
        fn = getattr(obj, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counter[_name] += 1
            return _fn(*a, **kw)
        setattr(obj, name, counted)


def _projection_bytes(tree) -> int:
    """Bytes of the projection weights of a (draft) parameter tree: the
    int8 bytes plus scales of {"q", "scale"} leaves, or the float
    leaves' bytes."""
    from repro_torch.models.layers import QUANT_WEIGHT_DIMS
    total = 0
    for name, sub in tree.items():
        if name in QUANT_WEIGHT_DIMS:
            leaves = sub.values() if isinstance(sub, dict) else [sub]
            total += sum(t.numel() * t.element_size() for t in leaves)
        elif isinstance(sub, dict):
            total += _projection_bytes(sub)
    return total


def serve_spec_phase(torch, kernels, serve, M, params, cfg, dev="cuda"):
    """Drive the third main path: the served model and traffic with
    speculative decoding on an int8 pool and an int8 draft of its first
    DRAFT_LAYERS layers.  Every wave is a verify extend wave; the draft's
    forward calls are counted around ``SpecDecoder._decode`` /
    ``_prefill``, each of which must run its 7 projections per layer
    through ``quant_matmul``.  Also times one draft decode step with the
    same layers in bf16 (before serving) and in int8 (after).  Returns
    phase fields."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    dcfg, dparams = make_draft(cfg, params, DRAFT_LAYERS)
    # one draft decode step (4 rows) on a dense cache of the path's size,
    # bf16 weights first: the bf16 copy is dropped before serving
    cache = M.init_cache(dcfg, 4, SERVE["max_len"], dev)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor([300, 211, 97, 33], dtype=torch.int32, device=dev)

    def draft_step_ms(p):
        return cuda_ms(torch, lambda i: M.decode_step(dcfg, p, cache, tok,
                                                      pos),
                       iters=10, warmup=2)
    bf16 = {"draft_bf16_projection_bytes": _projection_bytes(dparams),
            "draft_step_ms_bf16": draft_step_ms(dparams)}
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, quant_kv="int8", **SPEC,
        **SERVE), device=dev, draft=(dcfg, dparams))
    del dparams
    calls = {"_decode": 0, "_prefill": 0}
    _count_calls(eng.spec, calls, calls)
    L = cfg.num_layers
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_attention": 0,
        "paged_extend_attention": L * eng.extend_waves,
        "quant_matmul": 7 * DRAFT_LAYERS * sum(calls.values()),
        "ssd_scan": 0},
        needs=("paged_extend_attention", "quant_matmul"))
    st = eng.stats()
    if st["spec_rounds"] < 1 or not st["quant_draft"] \
            or eng.decode_waves != 0:
        raise AssertionError(f"serve_spec: {st} with {eng.decode_waves} "
                             "decode waves")
    fields.update(
        draft_layers=DRAFT_LAYERS, draft_calls=dict(calls),
        spec_rounds=st["spec_rounds"], spec_proposed=st["spec_proposed"],
        spec_accepted=st["spec_accepted"],
        spec_acceptance=st["spec_acceptance"],
        spec_tokens_per_round=st["spec_tokens_per_round"],
        acceptance_note="both models have random weights: acceptance near "
        "0 is expected and is no target",
        draft_int8_projection_bytes=_projection_bytes(eng.spec.params),
        draft_step_ms_int8=draft_step_ms(eng.spec.params), **bf16)
    fields["draft_step_profile_int8"] = _device_profile(
        torch, lambda: M.decode_step(dcfg, eng.spec.params, cache, tok, pos))
    # one draft admission prefill of a full group: 4 rows padded to the
    # bucket, M = 4 x DRAFT_BUCKET rows through each of the 7 x 8 int8
    # projections (SpecDecoder.admit_group's call)
    g = torch.Generator().manual_seed(5)
    rows = torch.randint(0, cfg.vocab_size, (4, DRAFT_BUCKET), generator=g,
                         dtype=torch.int32).to(dev)
    true_len = torch.tensor([DRAFT_BUCKET, 400, 300, 200], dtype=torch.int32,
                            device=dev)

    def draft_prefill():
        return M.prefill(dcfg, eng.spec.params, {"tokens": rows},
                         SERVE["max_len"], true_len=true_len)
    before = kernels["quant_matmul"].launches
    draft_prefill()
    fields.update(
        draft_prefill_rows=[4, DRAFT_BUCKET],
        draft_prefill_quant_matmul_launches=kernels["quant_matmul"].launches
        - before,
        draft_prefill_ms_int8=cuda_ms(torch, lambda i: draft_prefill(),
                                      iters=5, warmup=1),
        draft_prefill_profile_int8=_device_profile(torch, draft_prefill))
    return fields


def _serve_pool_free(torch, kernels, serve, M, arch, serve_kw, traffic,
                     per_prefill, scale, dev):
    """Serve ``traffic`` through ``launch.serve.build_engine(arch)``
    behind the pool-free engine (``use_pallas_paged=True``).  Admission
    prefill calls are counted around the engine's ``_admit_group`` (one
    fused prefill each, no pool to refuse a row), and each kernel of
    ``per_prefill(cfg)`` ({name: launches per prefill call}) must have
    launched that many times per call, every other kernel never.  Also
    times and profiles one 4-row decode wave.  Returns (engine, cfg,
    phase fields)."""
    clock = serve.default_clock
    t0 = clock()
    cfg, eng = serve.build_engine(arch, scale,
                                  dict(serve_kw, prefix_cache=False), dev)
    init_s = clock() - t0
    if eng.paged or eng.pool is not None:
        raise AssertionError(f"serve {arch}: the pool-free engine has a "
                             "page pool")
    calls = {"_admit_group": 0}
    _count_calls(eng, calls, calls)
    per = per_prefill(cfg)
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        name: n * calls["_admit_group"] for name, n in per.items()},
        needs=tuple(per), traffic=traffic)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((4,), dtype=torch.int32, device=dev)

    def wave():
        return M.decode_step(cfg, eng.params, eng.cache, tok, pos)
    fields.update(
        init_s=init_s, paged=eng.paged, prefill_calls=calls["_admit_group"],
        prefill_buckets=list(serve_kw["prefill_buckets"]),
        decode_wave_ms=cuda_ms(torch, lambda i: wave(), iters=10, warmup=2),
        decode_wave_profile=_device_profile(torch, wave))
    return eng, cfg, fields


def serve_ssm_phase(torch, kernels, serve, M, scale="full", dev="cuda"):
    """Drive the fourth main path: mamba2-370m at full width and depth
    behind the pool-free engine: every layer of every admission prefill
    scans through ``ssd_scan``; no paged or quant kernel runs."""
    return _serve_pool_free(torch, kernels, serve, M, SSM_ARCH, SSM_SERVE,
                            SSM_TRAFFIC,
                            lambda cfg: {"ssd_scan": cfg.num_layers}, scale,
                            dev)


def model_ssm_phase(torch, M, eng, cfg, dev="cuda"):
    """``ssm.prefill`` of one 4-row bucket-1024 batch with ragged
    ``true_len`` through the kernel and through the plain chunked path:
    at float32 activations the logits must agree within F32_REL_TOL x
    max |logit|, every layer's final SSM state within F32_REL_TOL x max
    |state|, and the greedy next tokens must be equal; then one such
    prefill of each is timed at the serving bf16 activations."""
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g,
                           dtype=torch.int32).to(dev)
    true_len = torch.tensor([1000, 777, 513, 300], dtype=torch.int32,
                            device=dev)
    batch = {"tokens": tokens}

    def run(c, use_kernel):
        return M.prefill(c, eng.params, batch, SSM_SERVE["max_len"],
                         true_len=true_len, use_kernel=use_kernel)
    cfg32 = cfg.replace(dtype="float32")
    ker, ker_cache = run(cfg32, True)
    gat, gat_cache = run(cfg32, False)
    ker, gat = ker[:, 0].float(), gat[:, 0].float()
    if not bool(torch.isfinite(ker).all() and torch.isfinite(gat).all()):
        raise AssertionError("model_ssm: non-finite logits")
    scale = float(gat.abs().max())
    d_logit = float((ker - gat).abs().max())
    st_k, st_g = ker_cache["layers"]["ssm"], gat_cache["layers"]["ssm"]
    st_scale = float(st_g.abs().max())
    d_state = float((st_k - st_g).abs().max())
    same = int((ker.argmax(-1) == gat.argmax(-1)).sum())
    if d_logit > F32_REL_TOL * scale or d_state > F32_REL_TOL * st_scale \
            or same != 4:
        raise AssertionError(
            f"model_ssm: kernel vs plain chunked prefill: logits differ by "
            f"{d_logit} (max {scale}), states by {d_state} (max "
            f"{st_scale}), greedy tokens agree {same}/4")
    del ker_cache, gat_cache
    times = {k: cuda_ms(torch, lambda i, k=k: run(cfg, k), iters=5, warmup=1)
             for k in (True, False)}
    return {"rows": 4, "bucket": 1024, "true_len": true_len.tolist(),
            "max_abs_logit_f32": scale, "f32_kernel_vs_plain": d_logit,
            "f32_tolerance": f"{F32_REL_TOL} x max |logit|",
            "max_abs_state_f32": st_scale, "f32_state_kernel_vs_plain":
            d_state, "state_tolerance": f"{F32_REL_TOL} x max |state|",
            "greedy_agree_f32": f"{same}/4",
            "prefill_ms_bf16_kernel": times[True],
            "prefill_ms_bf16_plain_chunked": times[False],
            "prefill_profile_bf16_kernel": _device_profile(
                torch, lambda: run(cfg, True))}


def _reference_pool_free(torch, serve_mod, get_smoke_config, kernels, arch,
                         needs, dev):
    """``arch``'s smoke config at float32 behind the pool-free engine,
    prompts of 4-150 tokens (those past the largest bucket, 64, catch up
    one token a decode wave): the card (hand kernels) and the CPU (plain
    versions) must emit the same greedy tokens, and each kernel of
    ``needs`` must have launched on the card.  Returns (card launches,
    longest prompt)."""
    from repro_torch.models import model as M
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    cfg = get_smoke_config(arch).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = {}
    for leg, leg_dev in (("cpu", "cpu"), ("card", dev)):
        eng = EdgeServingEngine(cfg, _to(params, leg_dev), ServeConfig(
            max_slots=3, max_len=192, prefix_cache=False,
            use_pallas_paged=True, policy="priority",
            prefill_buckets=(16, 32, 64)), device=leg_dev)
        reqs = serve_mod.make_requests(cfg, 6, 4, 150, 8, "priority")
        _zero(kernels)
        serve_mod.run_drain(eng, reqs)
        tokens[leg] = {r.uid: list(r.generated) for r in eng.completed}
    launches = _counts(kernels)
    longest = max(len(r.prompt) for r in reqs)
    if tokens["card"] != tokens["cpu"] or len(tokens["cpu"]) != 6 \
            or any(launches[n] == 0 for n in needs) or longest <= 64:
        raise AssertionError(f"reference {arch}: card tokens "
                             f"{tokens['card']} vs CPU {tokens['cpu']}, "
                             f"launches {launches}, longest prompt "
                             f"{longest}")
    return launches, longest


def reference_ssm(torch, serve_mod, get_smoke_config, kernels, dev="cuda"):
    """The mamba2 smoke config: card (``ssd_scan``) tokens equal to the
    CPU's (the sequential plain version)."""
    launches, longest = _reference_pool_free(
        torch, serve_mod, get_smoke_config, kernels, SSM_ARCH,
        ("ssd_scan",), dev)
    return {"ssm_arch": f"{SSM_ARCH} smoke, float32",
            "ssm_tokens_equal": True,
            "ssm_ssd_scan_launches": launches["ssd_scan"],
            "ssm_longest_prompt_past_bucket_64": longest > 64}


def _tree_equal(torch, a, b) -> bool:
    from torch.utils._pytree import tree_flatten
    (la, sa), (lb, sb) = tree_flatten(a), tree_flatten(b)
    return sa == sb and all(torch.equal(x.detach(), y.detach())
                            for x, y in zip(la, lb))


def train_phase(torch, kernels, train, M, argv=TRAIN_ARGV, dev="cuda"):
    """Drive the fifth main path's training half: gemma3-1b at full width
    and depth through ``repro_torch.launch.train``'s own flags, state and
    step — ``specs.build_train``'s step on the one-card mesh of
    ``mesh.make_local_mesh`` (NCCL, world size 1; its tensors stay plain,
    every placement being whole), as the CLI runs it (bigram data, AdamW,
    remat ``nothing_saveable``) — timing each step to a synchronised
    end.  One extra step of
    ``trainer.make_train_step`` on plain tensors from the same initial
    state and first batch gives loss, grad norm and new state bit for bit
    equal to the built step's, and its time.  The step runs the plain
    attention under autograd (no kernel has a backward), so every kernel
    count stays 0.  Returns (cfg, state as plain tensors, phase fields)."""
    from repro_torch.training import trainer as TR
    clock = train.default_clock
    args = train.parse_args([*argv, "--device", dev])
    on_card = dev != "cpu"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = clock()
    cfg, state, built, it = train.build(args)
    init_s = clock() - t0
    _zero(kernels)
    steps = []
    for i in range(args.steps):
        batch = next(it)
        t0 = clock()
        state0, (state, m) = state, built.fn(state, batch)
        _sync(torch)
        steps.append({"step": i, "ms": (clock() - t0) * 1e3,
                      **{k: float(v) for k, v in m.items()}})
        if i:
            continue
        # the direct step from the same state and batch
        direct = TR.make_train_step(cfg, train.train_config(args))
        t0 = clock()
        direct_state, dm = direct(state0, batch)
        _sync(torch)
        direct_ms = (clock() - t0) * 1e3
        metrics_equal = {k: float(dm[k]) == steps[0][k] for k in dm}
        state_equal = _tree_equal(torch, direct_state, state)
        del direct_state
        if not (all(metrics_equal.values()) and state_equal):
            raise AssertionError(
                f"train: build_train's step is not bit for bit "
                f"make_train_step's: metrics {metrics_equal}, state equal "
                f"{state_equal}")
    del state0
    launches = _counts(kernels)
    if any(launches.values()):
        raise AssertionError(f"train: kernels launched in a training step: "
                             f"{launches}")
    if not all(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])
               for st in steps):
        raise AssertionError(f"train: non-finite loss or grad norm {steps}")
    tokens = args.batch * args.seq
    later = [st["ms"] for st in steps[1:]] or [steps[0]["ms"]]
    fields = {
        "arch": cfg.name, "depth": cfg.num_layers, "depth_cut": False,
        "d_model": cfg.d_model, "params": M.count_params(state["params"]),
        "flags": vars(args), "init_s": init_s,
        "step_route": "specs.build_train on make_local_mesh (world size "
                      "1, plain tensors)",
        "steps": steps, "tokens_per_step": tokens,
        "direct_step_ms": direct_ms,
        "direct_step_equal": {"metrics": metrics_equal,
                              "state": state_equal},
        "ms_per_step_after_first": sum(later) / len(later),
        "tokens_per_s": tokens / (sum(later) / len(later) / 1e3),
        "launches": launches,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None)}
    batch = next(it)
    fields["step_profile"] = _device_profile(torch,
                                             lambda: built.fn(state, batch))
    return cfg, state, fields


def _trunk_order(cfg, trunk):
    """(layer params, is_global) in the trunk's order: each super-block's
    locals, its global, then the remainder locals."""
    from repro_torch.models.transformer import _layer
    nb, rem = cfg.pattern_blocks()
    out = []
    for i in range(nb):
        sp = _layer(trunk["super"], i)
        out += [(_layer(sp["local"], j), False)
                for j in range(cfg.pattern_period - 1)]
        out.append((sp["global"], True))
    out += [(_layer(trunk["rem_local"], i), False) for i in range(rem)]
    return out


def model_train_phase(torch, kernels, M, cfg, params, dev="cuda"):
    """Drive the fifth path's evaluation half on the trained weights:
    ``loss_fn(use_flash=True)`` against ``loss_fn(use_flash=False)`` under
    ``torch.no_grad()`` on a 2 x 4096 bigram batch.  At float32
    activations (TF32 off) the CE must agree within CE_F32_REL and the
    logits within LOGIT_F32_REL x max |logit|; at bf16 every layer's
    ``attention_fwd`` through the kernel and through the plain path, on
    identical inputs, within LAYER_BF16_REL x max |o| (the full-model CE
    gap is reported only).  ``flash_attention`` must launch once per
    layer of every forward through it, and nothing else may launch.
    Returns phase fields."""
    from repro_torch.data import DataConfig, synthetic_tokens
    from repro_torch.models import layers as L
    toks = torch.from_numpy(synthetic_tokens(
        DataConfig(seed=1, branching=4), cfg.vocab_size, EVAL_ROWS,
        EVAL_SEQ, 0)).to(dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    cfg32 = cfg.replace(dtype="float32")
    nL = cfg.num_layers
    forwards = 0
    _zero(kernels)
    res = {"rows": EVAL_ROWS, "seq": batch["tokens"].shape[1]}
    with torch.no_grad():
        ker = M.apply(cfg32, params, batch, use_flash=True)[0]
        plain = M.apply(cfg32, params, batch)[0]
        forwards += 1
        if not bool(torch.isfinite(ker).all() and torch.isfinite(plain).all()):
            raise AssertionError("model_train: non-finite logits")
        scale = float(plain.abs().max())
        d_logit = float((ker - plain).abs().max())
        del ker, plain
        ce = {}
        for name, c in (("f32", cfg32), ("bf16", cfg)):
            ce[f"{name}_kernel"] = float(M.loss_fn(c, params, batch,
                                                   use_flash=True)[1]["ce"])
            ce[f"{name}_plain"] = float(M.loss_fn(c, params, batch)[1]["ce"])
            forwards += 1
        d_ce = abs(ce["f32_kernel"] - ce["f32_plain"])
        if d_ce > CE_F32_REL * abs(ce["f32_plain"]) \
                or d_logit > LOGIT_F32_REL * scale:
            raise AssertionError(f"model_train: float32 kernel vs plain: CE "
                                 f"{ce}, logits differ by {d_logit} (max "
                                 f"{scale})")
        # bf16: every layer on identical inputs, the trunk walked plainly
        _, norm = L.make_norm(cfg)
        x = L.embed(cfg, params["embed"], batch["tokens"])
        S = x.shape[1]
        pos = torch.broadcast_to(torch.arange(S, dtype=torch.int32,
                                              device=x.device), x.shape[:2])
        layers = []
        for lp, is_global in _trunk_order(cfg, params["trunk"]):
            h = norm(lp["ln1"], x)
            ok_, k1, v1 = L.attention_fwd(cfg, lp["attn"], h, pos,
                                          is_global=is_global,
                                          use_flash=True)
            op_, k2, v2 = L.attention_fwd(cfg, lp["attn"], h, pos,
                                          is_global=is_global)
            err = float((ok_.float() - op_.float()).abs().max())
            top = float(op_.float().abs().max())
            layers.append({"global": is_global, "max_abs_err": err,
                           "max_abs_o": top})
            if err > LAYER_BF16_REL * top or not (torch.equal(k1, k2)
                                                  and torch.equal(v1, v2)):
                raise AssertionError(f"model_train: bf16 layer "
                                     f"{len(layers) - 1} (global "
                                     f"{is_global}): kernel vs plain "
                                     f"attention differ by {err} (max {top})")
            x = M.transformer.block_fwd(cfg, lp, x, pos, is_global=is_global)
        forwards += 1

        def loss(use_flash):
            return M.loss_fn(cfg, params, batch, use_flash=use_flash)[0]
        times = {k: cuda_ms(torch, lambda i, k=k: loss(k), iters=3,
                            warmup=1) for k in (True, False)}
        prof = _device_profile(torch, lambda: loss(True))
        forwards += 4 + 1
    launches = _counts(kernels)
    expect = dict.fromkeys(kernels, 0)
    expect["flash_attention"] = nL * forwards
    if launches != expect:
        raise AssertionError(f"model_train: kernel launches {launches} for "
                             f"{forwards} forwards of {nL} layers (expected "
                             f"{expect})")
    res.update({
        "max_abs_logit_f32": scale, "f32_logits_kernel_vs_plain": d_logit,
        "f32_logit_tolerance": f"{LOGIT_F32_REL} x max |logit|",
        "ce": ce, "f32_ce_kernel_vs_plain": d_ce,
        "f32_ce_tolerance": f"{CE_F32_REL} relative",
        "bf16_ce_kernel_minus_plain": ce["bf16_kernel"] - ce["bf16_plain"],
        "bf16_layers": layers,
        "bf16_layer_tolerance": f"{LAYER_BF16_REL} x max |o| of the layer",
        "forwards_through_kernel": forwards, "launches": launches,
        "loss_forward_ms_bf16_kernel": times[True],
        "loss_forward_ms_bf16_plain": times[False],
        "loss_forward_profile_bf16_kernel": prof})
    return res


def reference_train(torch, M, get_smoke_config, dev="cuda"):
    """The gemma3-1b smoke config at float32, 8 layers (2 super-blocks and
    2 remainder locals): ``loss_fn(use_flash=True)`` on the card (the
    kernel) equals the CPU's (the plain version) within CE_F32_REL, and
    two train steps (2 micro-batches, remat) on the card give the CPU's
    losses and gradient norms within 1e-4 relative."""
    from repro_torch.data import DataConfig, synthetic_tokens
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer as TR
    cfg = get_smoke_config(TRAIN_ARCH).replace(dtype="float32", num_layers=8)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = [torch.from_numpy(synthetic_tokens(DataConfig(), cfg.vocab_size,
                                              4, 64, s)) for s in range(2)]
    tcfg = TR.TrainConfig(optimizer=O.OptimizerConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=2), microbatches=2)
    res = {"train_arch": f"{TRAIN_ARCH} smoke, 8 layers, float32"}
    legs = {}
    for leg, leg_dev in (("cpu", "cpu"), ("card", dev)):
        p = _to(params, leg_dev)
        t = [x.to(leg_dev) for x in toks]
        with torch.no_grad():
            ce = float(M.loss_fn(cfg, p, {"tokens": t[0][:2, :-1],
                                          "targets": t[0][:2, 1:]},
                                 use_flash=True)[1]["ce"])
        state = {"params": p, "opt": O.init_opt_state(tcfg.optimizer, p)}
        step = TR.make_train_step(cfg, tcfg)
        hist = []
        for x in t:
            state, m = step(state, {"tokens": x[:, :-1], "targets": x[:, 1:]})
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        legs[leg] = (ce, hist)
    (ce_cpu, h_cpu), (ce_card, h_card) = legs["cpu"], legs["card"]
    res.update({"train_loss_flash_cpu": ce_cpu,
                "train_loss_flash_card": ce_card,
                "train_steps_cpu": h_cpu, "train_steps_card": h_card})
    if abs(ce_card - ce_cpu) > CE_F32_REL * abs(ce_cpu) or any(
            abs(a - b) > 1e-4 * abs(b)
            for x, y in zip(h_card, h_cpu) for a, b in zip(x, y)):
        raise AssertionError(f"reference train: card {legs['card']} vs CPU "
                             f"{legs['cpu']}")
    return res


def _int8_gate(card: dict, cpu: dict) -> tuple:
    """(first tokens equal, longest common prefix, tokens) of two runs'
    greedy tokens by request: the JAX package's int8 gate reads them."""
    first = sum(card[u][0] == cpu[u][0] for u in cpu)
    lcp = total = 0
    for u in cpu:
        total += len(cpu[u])
        for a, b in zip(cpu[u], card[u]):
            if a != b:
                break
            lcp += 1
    return first, lcp, total


def _gemma_drive(torch, kernels, serve, M, eng, cfg, int8: bool, dev):
    """Serve GEMMA_TRAFFIC through ``eng``: ``paged_attention`` launches
    == global layers x decode waves, and on an int8 pool
    ``paged_extend_attention`` launches == global layers x extend waves
    (a float pool's extend waves read through the gather, as in JAX);
    the traffic must hold a prompt past the largest bucket and the
    window, which catches up through extend waves and wraps the rings.
    Then times and profiles one 4-slot decode wave."""
    n_global = cfg.pattern_blocks()[0]
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_attention": n_global * eng.decode_waves,
        "paged_extend_attention": n_global * eng.extend_waves if int8 else 0,
        "quant_matmul": 0, "ssd_scan": 0},
        needs=("paged_attention",) + (("paged_extend_attention",)
                                      if int8 else ()),
        traffic=GEMMA_TRAFFIC)
    longest = max(fields["prompt_lengths"])
    W = min(cfg.local_window, eng.scfg.max_len)
    if longest <= max(eng.scfg.prefill_buckets) or longest <= W \
            or eng.extend_waves == 0 or not eng.extend_ok:
        raise AssertionError(f"serve_gemma: longest prompt {longest}, "
                             f"window {W}, {eng.extend_waves} extend waves")
    _, bt, pos, tok = _wave_state(torch, eng, cfg, 1, dev)

    def wave():
        return M.decode_step_paged(cfg, eng.params, eng.cache, tok, pos, bt,
                                   True)
    fields.update(
        global_layers=n_global, local_layers=cfg.num_layers - n_global,
        window=W, catch_chunk=eng.K, longest_prompt_past_window=longest - W,
        decode_wave_ms=cuda_ms(torch, lambda i: wave(), iters=10, warmup=2),
        decode_wave_profile=_device_profile(torch, wave))
    return fields


def serve_gemma_phase(torch, kernels, serve, M, scale="full", dev="cuda"):
    """Drive the sixth main path: gemma3-1b at full width and depth
    through ``launch.serve.build_engine`` on a bf16 pool; returns
    (engine, cfg, phase fields)."""
    clock = serve.default_clock
    t0 = clock()
    cfg, eng = serve.build_engine(GEMMA_ARCH, scale,
                                  dict(GEMMA_SERVE, prefix_cache=False), dev)
    init_s = clock() - t0
    fields = _gemma_drive(torch, kernels, serve, M, eng, cfg, False, dev)
    fields["init_s"] = init_s
    return eng, cfg, fields


def serve_gemma_int8_phase(torch, kernels, serve, M, eng0, cfg):
    """The same model (the first engine's weights) and traffic on an int8
    pool; the rings stay in the activation dtype."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    eng = EdgeServingEngine(cfg, eng0.params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, quant_kv="int8",
        **GEMMA_SERVE), device=eng0.device)
    fields = _gemma_drive(torch, kernels, serve, M, eng, cfg, True,
                          eng0.device)
    ring = eng.cache["super"]["local"]["k"].dtype
    if ring != eng0.cache["super"]["local"]["k"].dtype:
        raise AssertionError(f"serve_gemma_int8: rings in {ring}")
    return fields


def serve_gemma_wide_phase(torch, kernels, M, eng0, cfg):
    """A short drive of the first gemma engine's weights on an int8 pool
    with ``catch_chunk=64`` (GEMMA_WIDE_TRAFFIC: every prompt past the
    largest bucket catches up 64 tokens a slot a wave): with the hand
    kernels, ``paged_extend_attention`` launches == 4 global layers x
    extend waves, each call at S = 64 (the first version refused S >=
    22 at this shape); held against the same engine reading through the
    gather (``use_pallas_paged=False``) by the int8 gate."""
    from repro_torch.kernels import paged_extend_attention as pea
    from repro_torch.launch import serve
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    n_global = cfg.pattern_blocks()[0]
    widths = []
    kernel = pea.paged_extend_attention

    def recorded(q, *args, **kw):
        widths.append(int(q.shape[1]))
        return kernel(q, *args, **kw)
    tokens, res = {}, {}
    for leg, use_kernels in (("gather", False), ("kernels", True)):
        eng = EdgeServingEngine(cfg, eng0.params, ServeConfig(
            prefix_cache=False, use_pallas_paged=use_kernels,
            quant_kv="int8", **GEMMA_WIDE_SERVE), device=eng0.device)
        reqs = serve.make_requests(cfg, *GEMMA_WIDE_TRAFFIC, "priority")
        _zero(kernels)
        pea.paged_extend_attention = recorded
        try:
            raw = serve.run_drain(eng, reqs)
        finally:
            pea.paged_extend_attention = kernel
        launches = _counts(kernels)
        tokens[leg] = {r.uid: list(r.generated) for r in eng.completed}
        res[leg] = {"steps": raw["decode_steps"],
                    "decode_waves": eng.decode_waves,
                    "extend_waves": eng.extend_waves, "catch_chunk": eng.K,
                    "tok_per_s": raw["tok_per_s"], "launches": launches}
    extend = n_global * eng.extend_waves
    if launches["paged_extend_attention"] != extend or extend == 0 \
            or set(widths) != {GEMMA_WIDE_SERVE["catch_chunk"]} \
            or len(widths) != extend \
            or launches["paged_attention"] != n_global * eng.decode_waves:
        raise AssertionError(f"serve_gemma_wide: launches {launches} for "
                             f"{eng.decode_waves} decode and "
                             f"{eng.extend_waves} extend waves, extend "
                             f"widths {sorted(set(widths))}")
    first, lcp, total = _int8_gate(tokens["kernels"], tokens["gather"])
    n = len(tokens["gather"])
    if len(tokens["kernels"]) != n or first != n \
            or lcp < INT8_LCP_SHARE * total:
        raise AssertionError(f"serve_gemma_wide: first tokens {first}/{n}, "
                             f"LCP {lcp}/{total}: kernels "
                             f"{tokens['kernels']} vs gather "
                             f"{tokens['gather']}")
    return {"legs": res, "extend_widths": sorted(set(widths)),
            "prompt_lengths": [len(r.prompt) for r in reqs],
            "int8_first_tokens_equal": f"{first}/{n}",
            "int8_lcp_share": lcp / total,
            "tokens_equal": tokens["kernels"] == tokens["gather"],
            "launches": launches}


def serve_hybrid_phase(torch, kernels, serve, M, scale="full", dev="cuda"):
    """Drive the seventh main path: zamba2-7b at full width and depth
    behind the pool-free engine: each admission prefill scans its 68
    mamba blocks through ``ssd_scan`` and runs the shared block's 13
    applications through ``flash_attention``; no paged or quant kernel
    runs."""
    def per_prefill(cfg):
        n_attn = cfg.num_layers // cfg.hybrid_attn_period
        return {"ssd_scan": cfg.num_layers - n_attn, "flash_attention": n_attn}
    eng, cfg, fields = _serve_pool_free(
        torch, kernels, serve, M, HYBRID_ARCH, HYBRID_SERVE, HYBRID_TRAFFIC,
        per_prefill, scale, dev)
    per = per_prefill(cfg)
    fields.update(mamba_blocks=per["ssd_scan"],
                  attention_applications=per["flash_attention"],
                  ring=eng.cache["attn"]["k"].shape[2])
    return eng, cfg, fields


def model_hybrid_phase(torch, M, eng, cfg, dev="cuda"):
    """``hybrid.prefill`` of one 4-row bucket-1024 batch with ragged
    ``true_len`` through the kernels (``ssd_scan`` and
    ``flash_attention``) and through the plain path: at float32
    activations the logits must agree within F32_REL_TOL x max |logit|,
    every mamba state (conv and ssm) and every ring's K and V within
    F32_REL_TOL x their max, and the greedy next tokens must be equal;
    then one such prefill of each is timed at the serving bf16
    activations."""
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g,
                           dtype=torch.int32).to(dev)
    true_len = torch.tensor([1000, 777, 513, 300], dtype=torch.int32,
                            device=dev)
    batch = {"tokens": tokens}

    def run(c, kernels):
        return M.prefill(c, eng.params, batch, HYBRID_SERVE["max_len"],
                         true_len=true_len, use_kernel=kernels,
                         use_flash=kernels)
    cfg32 = cfg.replace(dtype="float32")
    ker, ker_cache = run(cfg32, True)
    gat, gat_cache = run(cfg32, False)
    ker, gat = ker[:, 0].float(), gat[:, 0].float()
    if not bool(torch.isfinite(ker).all() and torch.isfinite(gat).all()):
        raise AssertionError("model_hybrid: non-finite logits")
    scale = float(gat.abs().max())
    d_logit = float((ker - gat).abs().max())
    states = {}
    for part, leaves in (("mamba", ("conv", "ssm")), ("attn", ("k", "v"))):
        for leaf in leaves:
            want = gat_cache[part][leaf].float()
            states[f"{part}.{leaf}"] = (
                float((ker_cache[part][leaf].float() - want).abs().max()),
                float(want.abs().max()))
    if not torch.equal(ker_cache["attn"]["slots"], gat_cache["attn"]["slots"]):
        raise AssertionError("model_hybrid: ring slots differ")
    same = int((ker.argmax(-1) == gat.argmax(-1)).sum())
    bad = {k: v for k, v in states.items() if v[0] > F32_REL_TOL * v[1]}
    if d_logit > F32_REL_TOL * scale or bad or same != 4:
        raise AssertionError(
            f"model_hybrid: kernel vs plain prefill: logits differ by "
            f"{d_logit} (max {scale}), states beyond tolerance {bad}, "
            f"greedy tokens agree {same}/4")
    del ker_cache, gat_cache
    times = {k: cuda_ms(torch, lambda i, k=k: run(cfg, k), iters=5, warmup=1)
             for k in (True, False)}
    return {"rows": 4, "bucket": 1024, "true_len": true_len.tolist(),
            "max_abs_logit_f32": scale, "f32_kernel_vs_plain": d_logit,
            "f32_tolerance": f"{F32_REL_TOL} x max |logit| (and x max "
            "|value| of each state)",
            "f32_states_kernel_vs_plain_and_max": states,
            "greedy_agree_f32": f"{same}/4",
            "prefill_ms_bf16_kernels": times[True],
            "prefill_ms_bf16_plain": times[False],
            "prefill_profile_bf16_kernels": _device_profile(
                torch, lambda: run(cfg, True))}


def reference_hybrid(torch, serve_mod, get_smoke_config, kernels,
                     dev="cuda"):
    """The zamba2 smoke config (6 layers, window 16: prompts past 16
    wrap the rings): card (``ssd_scan`` and ``flash_attention``) tokens
    equal to the CPU's (plain versions)."""
    launches, longest = _reference_pool_free(
        torch, serve_mod, get_smoke_config, kernels, HYBRID_ARCH,
        ("ssd_scan", "flash_attention"), dev)
    return {"hybrid_arch": f"{HYBRID_ARCH} smoke, float32, window 16",
            "hybrid_tokens_equal": True, "hybrid_card_launches": launches,
            "hybrid_longest_prompt": longest}


def reference_gemma(torch, M, serve_mod, get_smoke_config, kernels,
                    dev="cuda"):
    """The gemma3-1b smoke config at float32 (window 16, 2 super-blocks
    of 2 local + 1 global layers): the engine on the card (hand kernels)
    and on the CPU (plain versions), prompts of 20-150 tokens (all past
    the window; those past the largest bucket catch up through extend
    waves).  On a float pool the greedy tokens must be equal; on an int8
    pool every first token equal and the longest common prefix at least
    INT8_LCP_SHARE of the tokens.  The card legs must have launched
    ``paged_attention`` and, on the int8 pool, ``paged_extend_attention``."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    cfg = get_smoke_config(GEMMA_ARCH).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    res = {"arch": f"{GEMMA_ARCH} smoke, float32", "requests": 6,
           "window": cfg.local_window}
    for pool in ("float32", "int8"):
        tokens = {}
        for leg, leg_dev in (("cpu", "cpu"), ("card", dev)):
            eng = EdgeServingEngine(cfg, _to(params, leg_dev), ServeConfig(
                max_slots=3, max_len=192, prefix_cache=False,
                use_pallas_paged=True, policy="priority",
                quant_kv="int8" if pool == "int8" else None),
                device=leg_dev)
            reqs = serve_mod.make_requests(cfg, 6, 20, 150, 8, "priority")
            _zero(kernels)
            serve_mod.run_drain(eng, reqs)
            tokens[leg] = {r.uid: list(r.generated) for r in eng.completed}
        launches = _counts(kernels)
        res[f"{pool}_card_launches"] = launches
        res[f"{pool}_waves_decode_extend"] = [eng.decode_waves,
                                              eng.extend_waves]
        need = ["paged_attention"] + (["paged_extend_attention"]
                                      if pool == "int8" else [])
        if any(launches[n] == 0 for n in need) or eng.extend_waves == 0:
            raise AssertionError(f"reference_gemma {pool}: launches "
                                 f"{launches}, {eng.extend_waves} extend "
                                 "waves")
        cpu, card = tokens["cpu"], tokens["card"]
        if len(card) != 6 or set(card) != set(cpu):
            raise AssertionError(f"reference_gemma {pool}: requests "
                                 f"{sorted(card)} on the card, "
                                 f"{sorted(cpu)} on the CPU")
        if pool == "float32":
            if card != cpu:
                raise AssertionError(f"reference_gemma: card tokens {card} "
                                     f"!= CPU tokens {cpu}")
            res["float32_tokens_equal"] = True
            continue
        first, lcp, total = _int8_gate(card, cpu)
        res.update({"int8_first_tokens_equal": f"{first}/{len(cpu)}",
                    "int8_lcp_share": lcp / total,
                    "int8_tokens_equal": card == cpu})
        if first != len(cpu) or lcp < INT8_LCP_SHARE * total:
            raise AssertionError(f"reference_gemma int8: first tokens "
                                 f"{first}/{len(cpu)}, LCP {lcp}/{total}: "
                                 f"card {card} vs CPU {cpu}")
    return res


def reference_phase(torch, M, serve_mod, get_smoke_config, qm, dev="cuda"):
    """Small input: the engine on the card (hand kernels) and on the CPU
    (plain versions) at float32.  On a float pool the greedy tokens must
    be equal; on an int8 pool, where one int8 level can move with the
    summation order, every first token must be equal and the longest
    common prefix at least INT8_LCP_SHARE of the tokens (the JAX
    package's int8 gate).  The speculative engine on the card, with an
    int8 draft of the first layer (of 2), is held the same way against
    the CPU's vanilla engine: equal tokens on the float pool (the
    verify model alone decides them), the int8 gate on the int8 pool;
    it must have run speculative rounds through ``quant_matmul``."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dcfg, dparams = make_draft(cfg, params, 1)
    res = {"arch": f"{ARCH} smoke, float32", "requests": 6,
           "spec_draft": f"first layer of {cfg.num_layers}, int8"}
    for pool in ("float32", "int8"):
        base = dict(max_slots=3, max_len=192, prefix_cache=False,
                    use_pallas_paged=True, policy="priority",
                    quant_kv="int8" if pool == "int8" else None)
        tokens, waves = {}, {}
        for leg, leg_dev in (("cpu", "cpu"), ("card", dev), ("spec", dev)):
            spec = leg == "spec"
            eng = EdgeServingEngine(
                cfg, _to(params, leg_dev),
                ServeConfig(**base, **(SPEC if spec else {})),
                device=leg_dev,
                draft=(dcfg, _to(dparams, leg_dev)) if spec else None)
            reqs = serve_mod.make_requests(cfg, 6, 4, 150, 8, "priority")
            qm.launches = 0
            serve_mod.run_drain(eng, reqs)
            tokens[leg] = {r.uid: list(r.generated) for r in eng.completed}
            waves[leg] = (eng.decode_waves, eng.extend_waves)
            if spec:
                st = eng.stats()
                res[f"{pool}_spec"] = {
                    "rounds": st["spec_rounds"],
                    "acceptance": st["spec_acceptance"],
                    "quant_matmul_launches": qm.launches}
                if st["spec_rounds"] < 1 or qm.launches == 0:
                    raise AssertionError(f"reference {pool} spec: {st}, "
                                         f"{qm.launches} quant_matmul "
                                         "launches")
        cpu = tokens["cpu"]
        for leg in ("card", "spec"):
            card = tokens[leg]
            name = pool if leg == "card" else f"{pool}_spec"
            if len(card) != 6 or set(card) != set(cpu):
                raise AssertionError(f"reference {name}: requests "
                                     f"{sorted(card)} on the card, "
                                     f"{sorted(cpu)} on the CPU")
            if pool == "float32":
                if card != cpu:
                    raise AssertionError(f"reference {name}: card tokens "
                                         f"{card} != CPU tokens {cpu}")
                res[f"{name}_tokens_equal"] = True
                continue
            first, lcp, total = _int8_gate(card, cpu)
            res.update({f"{name}_first_tokens_equal": f"{first}/{len(cpu)}",
                        f"{name}_lcp_share": lcp / total,
                        f"{name}_tokens_equal": card == cpu,
                        f"{name}_waves_decode_extend": list(waves[leg])})
            if first != len(cpu) or lcp < INT8_LCP_SHARE * total:
                raise AssertionError(f"reference {name}: first tokens "
                                     f"{first}/{len(cpu)}, LCP {lcp}/{total}"
                                     f": card {card} vs CPU {cpu}")
    return res


def _matrix_traffic(cfg, request_cls) -> list:
    """``tests/test_engine_matrix.py``'s mixed trace (copied): two
    shared-prefix families (one ending mid-page), a tiny prompt, a
    bucket-aligned one and one that catches up past the largest
    bucket."""
    import numpy as np
    rng = np.random.default_rng(42)
    vocab = cfg.vocab_size
    sys_a = rng.integers(0, vocab, 21, dtype=np.int32)
    sys_b = rng.integers(0, vocab, 16, dtype=np.int32)
    prompts = [
        np.concatenate([sys_a, rng.integers(0, vocab, 4, dtype=np.int32)]),
        np.concatenate([sys_a, rng.integers(0, vocab, 7, dtype=np.int32)]),
        np.concatenate([sys_b, rng.integers(0, vocab, 3, dtype=np.int32)]),
        np.concatenate([sys_b, rng.integers(0, vocab, 9, dtype=np.int32)]),
        rng.integers(0, vocab, 5, dtype=np.int32),
        rng.integers(0, vocab, 32, dtype=np.int32),
        rng.integers(0, vocab, 47, dtype=np.int32),
    ]
    return [request_cls(uid=uid, prompt=p, max_new_tokens=6,
                        priority=uid % 3, deadline=float(uid))
            for uid, p in enumerate(prompts)]


def reference_shared(torch, M, get_smoke_config, kernels, dev="cuda"):
    """The phi3 smoke config at float32 over the engine matrix's traffic:
    the dense twin on the card, the paged engine with the prefix cache
    and the hand-written reads on the card, the same speculating
    (self-draft), and the same on the CPU (plain versions) emit exactly
    the same greedy tokens; the prefix engine on an int8 pool on the card
    meets the JAX matrix's int8 gate against the dense twin; the prefix
    engines hit, the card's decode read launches, and no page leaks."""
    from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    base = dict(max_slots=3, max_len=96, prefill_buckets=(8, 16, 32), seed=3)
    legs = {"dense_card": (dev, dict(paged=False, use_pallas_paged=True)),
            "prefix_card": (dev, dict(use_pallas_paged=True)),
            "prefix_spec_card": (dev, dict(use_pallas_paged=True,
                                           spec_decode=True,
                                           draft_arch="self")),
            "prefix_cpu": ("cpu", dict(use_pallas_paged=True)),
            "prefix_int8_card": (dev, dict(use_pallas_paged=True,
                                           quant_kv="int8"))}
    res, tokens = {"arch": f"{ARCH} smoke, float32", "requests": 7}, {}
    for leg, (leg_dev, kw) in legs.items():
        eng = EdgeServingEngine(cfg, _to(params, leg_dev),
                                ServeConfig(**base, **kw), device=leg_dev)
        _zero(kernels)
        for r in _matrix_traffic(cfg, Request):
            eng.submit(r)
        eng.run_until_drained()
        launches = _counts(kernels)
        tokens[leg] = {r.uid: list(r.generated) for r in eng.completed}
        st = eng.stats()
        _check_pool(eng, f"reference_shared {leg}")
        res[leg] = {"prefix_hits": st.get("prefix_hits"),
                    "cow_forks": st["cow_forks"],
                    "spec_rounds": st.get("spec_rounds"),
                    "paged_attention_launches": launches["paged_attention"]}
        if (len(tokens[leg]) != 7
                or (eng.paged and st["prefix_hits"] < 1)
                or (kw.get("spec_decode") and st["spec_rounds"] < 1)
                or (leg == "prefix_card"
                    and launches["paged_attention"] == 0)
                or (not eng.paged and any(launches.values()))):
            raise AssertionError(f"reference_shared {leg}: {st}, "
                                 f"launches {launches}")
    ref = tokens.pop("dense_card")
    first, lcp, total = _int8_gate(tokens.pop("prefix_int8_card"), ref)
    res["prefix_int8_card"].update(first_tokens_equal=f"{first}/7",
                                   lcp_share=lcp / total)
    # tests/test_engine_matrix.py's gate for an int8 engine against the
    # float dense vanilla one: every first token but one, LCP >= 60%
    if first < 6 or lcp < INT8_LCP_SHARE * total:
        raise AssertionError(f"reference_shared int8: first {first}/7, "
                             f"LCP {lcp}/{total}")
    for leg, got in tokens.items():
        if got != ref:
            raise AssertionError(f"reference_shared: {leg} tokens {got} != "
                                 f"the dense twin's {ref}")
    res["tokens_equal"] = True
    return res


# ---------------------------------------------------------------------------
# the ninth path: the moe family (granite-moe-1b-a400m)
# ---------------------------------------------------------------------------

def _moe_block(cfg, pos, bt, S):
    """One layer of a moe cache's walk (``model.paged_layers``) as
    ``_layerwise_blocks`` calls it: a dense first layer through the
    transformer's block, a moe layer through moe's; a decode wave
    (``S`` None) or an extend wave of S tokens."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    def block(lp, x, pool, k):
        if S is None:
            fn = (moe.moe_block_decode_paged if "moe" in lp
                  else T.block_decode_paged)
            return fn(cfg, lp, x, pool, pos, bt, k)
        fn = (moe.moe_block_extend_paged if "moe" in lp
              else T.block_extend_paged)
        return fn(cfg, lp, x, pos, pool, bt, None, use_pallas=k)
    return block


def _moe_wave_bound(torch, eng, lengths) -> dict:
    """Least time of one decode wave of ``len(lengths)`` rows: every
    weight read once (all experts: each runs on its capacity of rows
    whether or not a row chose it; the tied embedding table as the
    unembedding), each row's K/V pages below its position read once,
    against the wave's operations at the bf16 rate."""
    cfg = eng.cfg

    def nbytes(node):
        if isinstance(node, dict):
            return sum(nbytes(v) for v in node.values())
        return node.numel() * node.element_size()
    weight = nbytes(eng.params)
    experts = nbytes({k: eng.params["moe_layers"]["moe"][k]
                      for k in ("w_gate", "w_up", "w_down")})
    pool = _pool(eng)
    kv = sum(lengths) * cfg.num_layers * 2 * cfg.num_kv_heads \
        * cfg.head_dim * pool["k"].element_size()
    from repro_torch.models import moe
    c = moe.capacity(cfg, len(lengths))
    ops = 2 * (cfg.num_layers - cfg.first_dense_layers) * cfg.num_experts \
        * c * 3 * cfg.d_model * cfg.moe_d_ff \
        + 2 * cfg.active_param_count() * len(lengths)
    ms, by = _roofline(weight + kv, ops, "bfloat16")
    return {"bound_ms": ms, "bound_by": by, "weight_bytes": weight,
            "expert_weight_bytes": experts,
            "expert_bytes_ms": experts / HBM_BYTES_PER_S * 1e3,
            "kv_bytes": kv, "capacity": c}


def _moe_drive(torch, kernels, serve, M, eng, cfg, int8: bool, dev):
    """Serve MOE_TRAFFIC through ``eng``: every layer of every decode wave
    through ``paged_attention`` and, on an int8 pool, every layer of
    every (catch-up) extend wave through ``paged_extend_attention`` (a
    float pool's extend waves read through the gather, as in JAX); a
    prompt past the largest bucket must catch up.  Then times and
    profiles one 4-slot decode wave, beside its bound."""
    L = cfg.num_layers
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_attention": L * eng.decode_waves,
        "paged_extend_attention": L * eng.extend_waves if int8 else 0,
        "quant_matmul": 0, "ssd_scan": 0},
        needs=("paged_attention",) + (("paged_extend_attention",)
                                      if int8 else ()),
        traffic=MOE_TRAFFIC)
    longest = max(fields["prompt_lengths"])
    if longest <= max(eng.scfg.prefill_buckets) or eng.extend_waves == 0:
        raise AssertionError(f"serve_moe: longest prompt {longest}, "
                             f"{eng.extend_waves} extend waves")
    lengths, bt, pos, tok = _wave_state(torch, eng, cfg, 1, dev)

    def wave():
        return M.decode_step_paged(cfg, eng.params, eng.cache, tok, pos, bt,
                                   True)
    fields.update(
        experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
        capacity_factor=cfg.capacity_factor, catch_chunk=eng.K,
        active_params=cfg.active_param_count(),
        decode_wave_lengths=lengths,
        decode_wave_ms=cuda_ms(torch, lambda i: wave(), iters=10, warmup=2),
        decode_wave_profile=_device_profile(torch, wave),
        decode_wave_bound=_moe_wave_bound(torch, eng, [n + 1 for n in
                                                       lengths]))
    return fields


def _serve_cli(torch, kernels, serve, argv, layers: int) -> dict:
    """``launch.serve.main(argv)``, the serve CLI at its defaults for an
    arch at full size (``--mode async``, the prefix cache on, on the
    card): its JSON line, every request finished, and decode reads
    through the kernel (one a paged layer of each decode wave) and
    nothing else."""
    import contextlib
    import io
    buf = io.StringIO()
    _zero(kernels)
    with contextlib.redirect_stdout(buf):
        serve.main(list(argv))
    launches = _counts(kernels)
    line = json.loads(next(ln for ln in buf.getvalue().splitlines()
                           if ln.startswith("{")))
    args = serve.parse_args(list(argv))
    n = launches["paged_attention"]
    if (line["requests"] != args.requests
            or line["tokens"] != args.requests * args.max_new
            or n == 0 or n % layers
            or any(v for k, v in launches.items() if k != "paged_attention")):
        raise AssertionError(f"{args.arch} CLI: {line}, launches {launches}")
    _release(torch)
    return {"argv": list(argv), "line": line, "launches": launches}


def serve_moe_phase(torch, kernels, serve, M, scale="full", dev="cuda"):
    """Drive the ninth main path: granite-moe-1b-a400m at full width and
    depth through ``launch.serve.build_engine`` on a bf16 pool, then the
    serve CLI at its defaults; returns (engine, cfg, phase fields), the
    fields' launches summing both."""
    clock = serve.default_clock
    t0 = clock()
    cfg, eng = serve.build_engine(MOE_ARCH, scale,
                                  dict(MOE_SERVE, prefix_cache=False), dev)
    init_s = clock() - t0
    fields = _moe_drive(torch, kernels, serve, M, eng, cfg, False, dev)
    fields["init_s"] = init_s
    fields["cli"] = _serve_cli(torch, kernels, serve, MOE_CLI_ARGV,
                               cfg.num_layers)
    fields["launches"] = {k: v + fields["cli"]["launches"][k]
                          for k, v in fields["launches"].items()}
    return eng, cfg, fields


def serve_moe_int8_phase(torch, kernels, serve, M, eng0, cfg, moe_tokens,
                         dev="cuda"):
    """The same weights and traffic on an int8 pool; then every layer's
    kernel read against the gather read on identical inputs and a copy
    of the same pool at float32 activations (``_layerwise_blocks`` over
    ``model.paged_layers``), for a decode and a 16-token extend wave.
    Tokens are reported against ``serve_moe``'s by the int8 gate."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    eng = EdgeServingEngine(cfg, eng0.params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, quant_kv="int8",
        **MOE_SERVE), device=eng0.device)
    fields = _moe_drive(torch, kernels, serve, M, eng, cfg, True, dev)
    tokens = {r.uid: list(r.generated) for r in eng.completed}
    first, lcp, total = _int8_gate(tokens, moe_tokens)
    fields.update(bf16_first_tokens_equal=f"{first}/{len(moe_tokens)}",
                  bf16_lcp_share=lcp / total,
                  bf16_tokens_equal=tokens == moe_tokens)
    S = eng.K
    _, bt, pos, tok = _wave_state(torch, eng, cfg, S, dev)
    cfg32 = cfg.replace(dtype="float32")
    for name, tokens_in, width in (("decode", tok[:, :1], None),
                                   ("extend", tok, S)):
        err, ok = _layerwise_blocks(torch, cfg32, eng.params, eng.cache,
                                    tokens_in, _moe_block(cfg32, pos, bt,
                                                          width))
        fields[f"{name}_layerwise_max_abs_err"] = err
        if not ok:
            raise AssertionError(f"serve_moe_int8: {name} kernel read "
                                 f"differs from the gather read on "
                                 f"identical inputs by {err}")
    fields["layer_tolerance"] = TOL["float32"]
    del eng
    _release(torch)
    return fields


def serve_moe_shared_phase(torch, kernels, serve, M, params, cfg,
                           dev="cuda"):
    """granite at ``ServeConfig()``'s defaults (the radix prefix cache
    on), max_len 512, the hand-written reads, with the household traffic
    of ``_shared_requests``: 7 hits and 1 miss, 7 x 210 hit tokens (the
    system prompt and the persona), ``paged_attention`` == 24 x decode
    waves, no page leaked.  The hit rows' tokens are reported against a
    cold engine of the same weights: capacity follows the suffix's
    shape, so they need not be equal."""
    from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
    L = cfg.num_layers
    eng = EdgeServingEngine(cfg, params, ServeConfig(**SHARED_SERVE),
                            device=dev)
    if not (eng.sharable and eng.paged and eng.prefix_cache is not None):
        raise AssertionError("serve_moe_shared: the prefix cache is off")
    reqs = _shared_requests(cfg, Request)
    run = _shared_drive(torch, kernels, serve, eng, reqs)
    st = eng.stats()
    expect = dict.fromkeys(kernels, 0)
    expect["paged_attention"] = L * run["decode_waves"]
    run.update({k: st[f"prefix_{k}"] for k in (
        "hits", "misses", "hit_tokens", "hit_tokens_block", "cached_blocks")})
    run.update(cow_forks=st["cow_forks"],
               predicted={"hits": SHARED_USERS - 1,
                          "hit_tokens": (SHARED_USERS - 1)
                          * (SHARED_SYS + SHARED_PERSONA)})
    if run["launches"] != expect or run["decode_waves"] == 0:
        raise AssertionError(f"serve_moe_shared: launches {run['launches']}"
                             f", expected {expect}")
    if (run["hits"], run["misses"], run["hit_tokens"]) != (
            SHARED_USERS - 1, 1, run["predicted"]["hit_tokens"]):
        raise AssertionError(f"serve_moe_shared: {st}")
    _check_pool(eng, "serve_moe_shared")
    del eng
    cold_eng = EdgeServingEngine(cfg, params, ServeConfig(
        **SHARED_SERVE, prefix_cache=False), device=dev)
    cold_reqs = _shared_requests(cfg, Request)
    cold = _shared_drive(torch, kernels, serve, cold_eng, cold_reqs)
    _check_pool(cold_eng, "serve_moe_shared cold")
    del cold_eng
    _release(torch)
    hot_tok = {r.uid: list(r.generated) for r in reqs[1:]}
    cold_tok = {r.uid: list(r.generated) for r in cold_reqs[1:]}
    first, lcp, total = _int8_gate(hot_tok, cold_tok)
    run.update(arch=cfg.name, depth=L, cold={k: cold[k] for k in (
        "tok_per_s", "ms_per_step", "ttft_user0_ms", "ttft_users1_7_p50_ms",
        "steps", "decode_waves", "extend_waves")},
        hit_first_tokens_equal_cold=f"{first}/{len(hot_tok)}",
        hit_lcp_share_cold=lcp / total,
        hit_tokens_equal_cold=hot_tok == cold_tok)
    return run


class _RouteRecorder:
    """Within a ``with`` block, every ``moe._route`` call appends its
    (experts, kept) pair, both (N, k), to ``calls``."""

    def __init__(self, moe):
        self.moe, self.orig, self.calls = moe, moe._route, []

    def __enter__(self):
        def recording(*args, **kw):
            out = self.orig(*args, **kw)
            self.calls.append((out[1], out[3]))
            return out
        self.moe._route = recording
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig


def model_moe_phase(torch, M, eng, cfg, dev="cuda"):
    """(a) One 4-slot decode wave on ``serve_moe``'s served pool, kernel
    read against gather read: at float32 activations (the reads differ
    in summation order only) greedy tokens equal and logits within
    F32_REL_TOL x max |logit|; at the serving bf16 activations, where
    the gather path rounds its probabilities to bf16, the logits, greedy
    agreement and each layer's (token, choice) pairs routed to another
    expert are reported: a router choice within the rounding difference
    of the next one flips, capacity (2 rows an expert) then moves other
    rows' pairs, and the difference grows through the 24 layers.
    (b) Routing of the first moe layer on the card against the CPU,
    float32 weights, on its normed input (computed once on the card) for
    a 4 x 512 admission batch: experts, positions and kept pairs equal
    but at (token, choice) pairs whose sorted router logits lie within
    ROUTER_NEAR_TIE of a neighbour's across a choice boundary (counted);
    the mixture outputs of rows routed alike within TOL["float32"].
    (c) The share of real (token, choice) pairs dropped, over every moe
    layer, in a decode wave, a 16-token catch-up wave and the 4 x 512
    prefill."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    res = {}
    _, bt, pos, tok = _wave_state(torch, eng, cfg, 1, dev)
    cfg32 = cfg.replace(dtype="float32")

    def wave(c, use_kernel):
        with _RouteRecorder(moe) as rec:
            out = M.decode_step_paged(c, eng.params, eng.cache, tok, pos, bt,
                                      use_kernel)[0][:, 0].float()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("model_moe: non-finite logits")
        return out, rec.calls
    (ker32, rk32), (gat32, rg32) = wave(cfg32, True), wave(cfg32, False)
    scale = float(gat32.abs().max())
    d32 = float((ker32 - gat32).abs().max())
    same32 = int((ker32.argmax(-1) == gat32.argmax(-1)).sum())
    if d32 > F32_REL_TOL * scale or same32 != 4:
        raise AssertionError(f"model_moe: float32 kernel vs gather logits "
                             f"differ by {d32} (max |logit| {scale}), "
                             f"argmax {same32}/4")
    (ker16, rk), (gat16, rg) = wave(cfg, True), wave(cfg, False)

    def apart(rk, rg):
        return [int((ek != eg).sum()) for (ek, _), (eg, _) in zip(rk, rg)]
    flips = apart(rk, rg)
    res.update(max_abs_logit_f32=scale, f32_kernel_vs_gather=d32,
               f32_pairs_routed_apart_by_layer=apart(rk32, rg32),
               f32_tolerance=f"{F32_REL_TOL} x max |logit|",
               argmax_agree_f32_kernel_gather=f"{same32}/4",
               bf16_kernel_vs_gather=float((ker16 - gat16).abs().max()),
               bf16_max_abs_logit=float(gat16.abs().max()),
               argmax_agree_bf16_kernel_gather=(
                   f"{int((ker16.argmax(-1) == gat16.argmax(-1)).sum())}/4"),
               bf16_pairs_routed_apart_by_layer=flips,
               bf16_first_layer_routed_apart=next(
                   (i for i, n in enumerate(flips) if n), None))

    # (b) routing on the card against the CPU
    Bq, S = MOE_ROUTE_ROWS
    g = torch.Generator().manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (Bq, S), dtype=torch.int32,
                           generator=g).to(dev)
    first = next(lp for lp, _ in M.paged_layers(cfg, eng.params, eng.cache)
                 if "moe" in lp)
    p32 = _tree(lambda t: t.float(), first)
    _, norm = L.make_norm(cfg32)
    with torch.no_grad():
        x = L.embed(cfg32, eng.params["embed"], tokens)
        positions = torch.broadcast_to(torch.arange(
            S, dtype=torch.int32, device=x.device), (Bq, S))
        a, _, _ = L.attention_fwd(cfg32, p32["attn"], norm(p32["ln1"], x),
                                  positions, is_global=True)
        h = norm(p32["ln2"], x + a).reshape(Bq * S, -1).contiguous()
        p_cpu = _tree(lambda t: t.cpu(), p32["moe"])
        _, e_ca, pos_ca, v_ca, _ = (t.cpu() for t in moe._route(
            cfg32, p32["moe"]["router"], h))
        _, e_cp, pos_cp, v_cp, _ = moe._route(cfg32, p_cpu["router"],
                                              h.cpu())
        out_card = moe._moe_tokens(cfg32, p32["moe"], h)[0].cpu()
        out_cpu = moe._moe_tokens(cfg32, p_cpu, h.cpu())[0]
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    logits = torch.matmul(h.cpu(), p_cpu["router"])
    srt = torch.sort(logits, dim=-1, descending=True).values
    gap = srt[:, 1:k + 1] - srt[:, :k]                   # (N, k): j vs j+1
    tie = gap.abs() < ROUTER_NEAR_TIE
    near = tie.clone()
    near[:, 1:] |= tie[:, :-1]                           # j-1 vs j as well
    flip = e_ca != e_cp
    if bool((flip & ~near).any()):
        raise AssertionError(f"model_moe: card routing differs from the "
                             f"CPU's at {int((flip & ~near).sum())} pairs "
                             f"that are not near-ties")
    touched = torch.unique(torch.cat([e_ca[flip], e_cp[flip]]))
    comparable = ~torch.isin(e_cp, touched)
    if not bool(((pos_ca == pos_cp) & (v_ca == v_cp))[comparable].all()):
        raise AssertionError("model_moe: card positions or kept pairs "
                             "differ from the CPU's")
    alike = ((e_ca == e_cp) & (pos_ca == pos_cp) & (v_ca == v_cp)).all(dim=1)
    oc, op = out_card[alike], out_cpu[alike]
    if not bool(torch.allclose(oc, op, **TOL["float32"])):
        raise AssertionError(f"model_moe: outputs of rows routed alike "
                             f"differ by {float((oc - op).abs().max())}")
    res.update(route_rows=[Bq, S], route_capacity=moe.capacity(cfg, Bq * S),
               route_near_tie_pairs=int(near.sum()),
               route_flipped_pairs=int(flip.sum()),
               route_rows_alike=f"{int(alike.sum())}/{Bq * S}",
               route_out_max_abs_err=float((oc - op).abs().max()),
               route_near_tie=ROUTER_NEAR_TIE,
               route_out_tolerance=TOL["float32"])

    # (c) dropped shares, recorded around moe._route
    S16 = eng.K
    _, bt16, pos16, tok16 = _wave_state(torch, eng, cfg, S16, dev)
    calls = {
        "decode": (4, lambda: M.decode_step_paged(
            cfg, eng.params, eng.cache, tok, pos, bt, True)),
        f"catch_up_{S16}": (4 * S16, lambda: M.extend_paged(
            cfg, eng.params, eng.cache, tok16, pos16, bt16, None, True)),
        f"prefill_{Bq}x{S}": (Bq * S, lambda: M.prefill(
            cfg, eng.params, {"tokens": tokens}, S))}
    for name, (rows, call) in calls.items():
        with _RouteRecorder(moe) as rec, torch.no_grad():
            call()
        real = sum(int((e < cfg.num_experts).sum()) for e, _ in rec.calls)
        dropped = sum(int(((e < cfg.num_experts) & ~v).sum())
                      for e, v in rec.calls)
        res[f"dropped_share_{name}"] = dropped / real
        res[f"capacity_{name}"] = moe.capacity(cfg, rows)
    return res


def _moe_reference_requests(cfg, request_cls) -> list:
    """Seven requests of 5-150 prompt tokens (those past the largest
    bucket catch up) whose budgets free slots at different waves, so idle
    slots ride the decode waves beside live ones."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [request_cls(uid=u, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(5, 151)), dtype=np.int32),
        max_new_tokens=n, priority=u % 3)
        for u, n in enumerate((3, 8, 2, 6, 10, 4, 5))]


def reference_moe(torch, M, get_smoke_config, kernels, dev="cuda"):
    """The granite and kimi smoke configs at float32 and their default
    capacity factor (1.25: pairs drop): the engine on the card (hand
    kernels) and on the CPU (plain versions) over traffic whose slots go
    idle mid-run and whose long prompts catch up.  On a float pool the
    greedy tokens must be equal; on an int8 pool they meet the JAX int8
    gate.  The card legs must have launched ``paged_attention`` and, on
    int8, ``paged_extend_attention``."""
    from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
    res = {}
    for arch in (MOE_ARCH, "kimi-k2-1t-a32b"):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        out = {"capacity_factor": cfg.capacity_factor}
        for pool in ("float32", "int8"):
            tokens = {}
            for leg, leg_dev in (("cpu", "cpu"), ("card", dev)):
                eng = EdgeServingEngine(cfg, _to(params, leg_dev),
                                        ServeConfig(
                    max_slots=3, max_len=192, prefix_cache=False,
                    use_pallas_paged=True, policy="priority",
                    quant_kv="int8" if pool == "int8" else None),
                    device=leg_dev)
                _zero(kernels)
                for r in _moe_reference_requests(cfg, Request):
                    eng.submit(r)
                eng.run_until_drained()
                tokens[leg] = {r.uid: list(r.generated)
                               for r in eng.completed}
            launches = _counts(kernels)
            need = ["paged_attention"] + (["paged_extend_attention"]
                                          if pool == "int8" else [])
            out[f"{pool}_card_launches"] = launches
            out[f"{pool}_waves_decode_extend"] = [eng.decode_waves,
                                                  eng.extend_waves]
            if any(launches[n] == 0 for n in need) or eng.extend_waves == 0:
                raise AssertionError(f"reference_moe {arch} {pool}: "
                                     f"launches {launches}")
            cpu, card = tokens["cpu"], tokens["card"]
            if set(card) != set(cpu) or len(cpu) != 7:
                raise AssertionError(f"reference_moe {arch} {pool}: "
                                     f"requests {sorted(card)}")
            if pool == "float32":
                if card != cpu:
                    raise AssertionError(f"reference_moe {arch}: card "
                                         f"tokens {card} != CPU {cpu}")
                out["float32_tokens_equal"] = True
                continue
            first, lcp, total = _int8_gate(card, cpu)
            out.update(int8_first_tokens_equal=f"{first}/{len(cpu)}",
                       int8_lcp_share=lcp / total,
                       int8_tokens_equal=card == cpu)
            if first != len(cpu) or lcp < INT8_LCP_SHARE * total:
                raise AssertionError(f"reference_moe {arch} int8: first "
                                     f"{first}/{len(cpu)}, LCP {lcp}/"
                                     f"{total}")
        res[arch] = out
    return res


# ---------------------------------------------------------------------------
# the tenth path: the vlm and encdec families (requests with extras)
# ---------------------------------------------------------------------------

def _nbytes(node) -> int:
    if isinstance(node, dict):
        return sum(_nbytes(v) for v in node.values())
    return node.numel() * node.element_size()


def _numel(node) -> int:
    if isinstance(node, dict):
        return sum(_numel(v) for v in node.values())
    return node.numel()


def _extras_wave_bound(torch, eng, cfg, lengths) -> dict:
    """Least time of one decode wave of ``len(lengths)`` rows at
    positions ``lengths``: the weights the wave reads once (the vlm's
    trunk and untied head, not its embedding table or projector; the
    encdec's decoder and tied table), each row's K/V pages below its
    position (and the encdec's cross K/V) read once, against two
    operations a weight and row at the bf16 rate."""
    p = eng.params
    B = len(lengths)
    parts = ([p["trunk"], p["unembed"], p["final_norm"]]
             if cfg.family == "vlm" else [p["decoder"], p["embed"],
                                          p["dec_ln"]])
    weight = sum(_nbytes(x) for x in parts)
    kv_row = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim
    kv = sum(lengths) * kv_row * _pool(eng)["k"].element_size()
    cross = (0 if cfg.family == "vlm" else B * kv_row * cfg.encoder_seq
             * eng.cache["cross_k"].element_size())
    ms, by = _roofline(weight + kv + cross,
                       2 * B * sum(_numel(x) for x in parts), "bfloat16")
    return {"bound_ms": ms, "bound_by": by, "weight_bytes": weight,
            "weight_bytes_ms": weight / HBM_BYTES_PER_S * 1e3,
            "kv_bytes": kv, "cross_kv_bytes": cross}


def _extras_drive(torch, kernels, serve, M, eng, cfg, int8: bool, traffic,
                  dev):
    """Serve ``traffic`` (each request with its image or audio) through
    ``eng``: every layer of every decode wave through ``paged_attention``
    and, on an int8 pool, every layer of every extend wave through
    ``paged_extend_attention`` (a float pool's extend waves read through
    the gather, as in JAX); a prompt must catch up.  Then times and
    profiles one 4-slot decode wave beside its bound."""
    from repro_torch.configs import get_config
    L = cfg.num_layers
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_attention": L * eng.decode_waves,
        "paged_extend_attention": L * eng.extend_waves if int8 else 0},
        needs=("paged_attention",) + (("paged_extend_attention",)
                                      if int8 else ()),
        traffic=traffic)
    full = get_config(cfg.name).num_layers
    if L != full:
        fields["depth_cut"] = (f"{L} of {full} layers (the one cut; every "
                               "width as published)")
    if eng.extend_waves == 0:
        raise AssertionError(f"{cfg.name}: no prompt caught up")
    lengths, bt, pos, tok = _wave_state(torch, eng, cfg, 1, dev)

    def wave():
        return M.decode_step_paged(cfg, eng.params, eng.cache, tok, pos, bt,
                                   True)
    fields.update(
        catch_chunk=eng.K, chunked_prefill=eng.chunked,
        extras={k: list(v.shape) for k, v in
                eng.completed[0].extras.items()},
        decode_wave_lengths=lengths,
        decode_wave_ms=cuda_ms(torch, lambda i: wave(), iters=10, warmup=2),
        decode_wave_profile=_device_profile(torch, wave),
        decode_wave_bound=_extras_wave_bound(torch, eng, cfg,
                                             [n + 1 for n in lengths]))
    return fields


def _vlm_config(scale):
    """internvl2-76b at full width and VLM_LAYERS of its layers (or the
    smoke config)."""
    from repro_torch.configs import get_config, get_smoke_config
    if scale == "smoke":
        return get_smoke_config(VLM_ARCH)
    return get_config(VLM_ARCH).replace(num_layers=VLM_LAYERS)


def serve_vlm_phase(torch, kernels, serve, M, scale="full", dev="cuda"):
    """Drive the tenth main path's vlm: internvl2-76b at full width,
    VLM_LAYERS deep, bf16 weights from seed 0 through ``model.init_params``
    and ``EdgeServingEngine`` (``launch.serve.build_engine`` builds every
    layer, 141 GB) on a bf16 pool at VLM_SERVE, VLM_TRAFFIC with one
    image a request; returns (engine, cfg, phase fields)."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    clock = serve.default_clock
    t0 = clock()
    cfg = _vlm_config(scale)
    if torch.device(dev).type == "cuda":
        cfg = cfg.replace(param_dtype=cfg.dtype)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, **VLM_SERVE), device=dev)
    _sync(torch)
    init_s = clock() - t0
    fields = _extras_drive(torch, kernels, serve, M, eng, cfg, False,
                           VLM_TRAFFIC, dev)
    fields.update(
        init_s=init_s, heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
        d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        image_tokens=[cfg.num_image_tokens, cfg.image_embed_dim],
        weight_gb=_nbytes(params) / 1e9)
    return eng, cfg, fields


def serve_vlm_int8_phase(torch, kernels, serve, M, eng0, cfg, vlm_tokens,
                         dev="cuda"):
    """The same weights and traffic on an int8 pool: catch-up waves
    through ``paged_extend_attention``; then every layer's kernel read
    against the gather read on identical inputs and a copy of the same
    pool at float32 activations (``_layerwise_blocks`` over
    ``model.paged_layers``), for a decode and a 16-token extend wave.
    Tokens are reported against ``serve_vlm``'s by the int8 gate."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    eng = EdgeServingEngine(cfg, eng0.params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, quant_kv="int8",
        **VLM_SERVE), device=eng0.device)
    fields = _extras_drive(torch, kernels, serve, M, eng, cfg, True,
                           VLM_TRAFFIC, dev)
    tokens = {r.uid: list(r.generated) for r in eng.completed}
    first, lcp, total = _int8_gate(tokens, vlm_tokens)
    fields.update(bf16_first_tokens_equal=f"{first}/{len(vlm_tokens)}",
                  bf16_lcp_share=lcp / total,
                  bf16_tokens_equal=tokens == vlm_tokens)
    S = eng.K
    _, bt, pos, tok = _wave_state(torch, eng, cfg, S, dev)
    cfg32 = cfg.replace(dtype="float32")
    blocks = {
        "decode": (tok[:, :1], lambda lp, x, pg, k: T.block_decode_paged(
            cfg32, lp, x, pg, pos, bt, k)),
        "extend": (tok, lambda lp, x, pg, k: T.block_extend_paged(
            cfg32, lp, x, pos, pg, bt, None, use_pallas=k))}
    for name, (tokens_in, block) in blocks.items():
        err, ok = _layerwise_blocks(torch, cfg32, eng.params, eng.cache,
                                    tokens_in, block)
        fields[f"{name}_layerwise_max_abs_err"] = err
        if not ok:
            raise AssertionError(f"serve_vlm_int8: {name} kernel read "
                                 f"differs from the gather read on "
                                 f"identical inputs by {err}")
    fields["layer_tolerance"] = TOL["float32"]
    del eng
    _release(torch)
    return fields


def _vlm_shared_requests(cfg, request_cls) -> list:
    """serve_shared's household traffic (``_shared_requests``) with one
    image for users 0-7 (seed 1), and a ninth user with another image
    (seed 2) and user 1's text."""
    import numpy as np
    shape = (cfg.num_image_tokens, cfg.image_embed_dim)
    image, other = (np.random.default_rng(s).normal(0, 0.1, shape)
                    .astype(np.float32) for s in (1, 2))
    reqs = _shared_requests(cfg, request_cls)
    for r in reqs:
        r.extras = {"image_embeds": image}
    reqs.append(request_cls(uid=SHARED_USERS, max_new_tokens=SHARED_NEW,
                            prompt=reqs[1].prompt.copy(),
                            extras={"image_embeds": other}))
    return reqs


def serve_vlm_shared_phase(torch, kernels, serve, M, params, cfg,
                           dev="cuda"):
    """internvl2 at ``ServeConfig()``'s other defaults (the radix prefix
    cache on, not chunked) with max_len 1024, buckets to 512 and the
    hand-written reads, over ``_vlm_shared_requests``.  Predicted from
    the schedule before the run: user 0 alone to its first token
    publishes its chain past the shared text, so users 1-7 each hit
    exactly the image and the shared text (256 + 210 tokens: 7 hits,
    3262 hit tokens), and the ninth user, whose image differs, misses
    (2 misses).  Each request's acquired context is recorded at its
    admission.  ``paged_attention`` == layers x decode waves, no page
    leaked; the hit rows' first tokens equal a cold engine's, their
    longest common prefix with it reported."""
    from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
    L, P = cfg.num_layers, cfg.num_image_tokens
    share = P + SHARED_SYS + SHARED_PERSONA
    predicted = {"hits": SHARED_USERS - 1, "misses": 2,
                 "hit_tokens": (SHARED_USERS - 1) * share}
    eng = EdgeServingEngine(cfg, params, ServeConfig(**VLM_SHARED_SERVE),
                            device=dev)
    if not (eng.sharable and eng.paged and not eng.chunked):
        raise AssertionError("serve_vlm_shared: the prefix cache is off")
    acquired = {}
    lookup = eng._lookup

    def recording(req):
        lookup(req)
        acquired[req.uid] = req._ctx_len
    eng._lookup = recording
    reqs = _vlm_shared_requests(cfg, Request)
    run = _shared_drive(torch, kernels, serve, eng, reqs)
    del eng._lookup
    st = eng.stats()
    expect = dict.fromkeys(kernels, 0)
    expect["paged_attention"] = L * run["decode_waves"]
    run.update({k: st[f"prefix_{k}"] for k in (
        "hits", "misses", "hit_tokens", "hit_tokens_block", "cached_blocks")})
    run.update(cow_forks=st["cow_forks"], predicted=predicted,
               acquired_context=acquired, image_tokens=P)
    if run["launches"] != expect or run["decode_waves"] == 0:
        raise AssertionError(f"serve_vlm_shared: launches "
                             f"{run['launches']}, expected {expect}")
    if {k: run[k] for k in predicted} != predicted or acquired != {
            u: (0 if u in (0, SHARED_USERS) else share)
            for u in range(SHARED_USERS + 1)}:
        raise AssertionError(f"serve_vlm_shared: {st}, acquired "
                             f"{acquired}, predicted {predicted}")
    _check_pool(eng, "serve_vlm_shared")
    del eng
    _release(torch)
    cold_eng = EdgeServingEngine(cfg, params, ServeConfig(
        **VLM_SHARED_SERVE, prefix_cache=False), device=dev)
    cold_reqs = _vlm_shared_requests(cfg, Request)
    cold = _shared_drive(torch, kernels, serve, cold_eng, cold_reqs)
    _check_pool(cold_eng, "serve_vlm_shared cold")
    del cold_eng
    _release(torch)
    hot_tok = {r.uid: list(r.generated) for r in reqs[1:]}
    cold_tok = {r.uid: list(r.generated) for r in cold_reqs[1:]}
    first, lcp, total = _int8_gate(hot_tok, cold_tok)
    run.update(arch=cfg.name, depth=L, cold={k: cold[k] for k in (
        "tok_per_s", "ms_per_step", "ttft_user0_ms", "ttft_users1_7_p50_ms",
        "steps", "decode_waves", "extend_waves")},
        hit_first_tokens_equal_cold=f"{first}/{len(hot_tok)}",
        hit_lcp_share_cold=lcp / total,
        hit_tokens_equal_cold=hot_tok == cold_tok)
    # every hit row's first token (its suffix prefill's own output over
    # the image and text read from shared pages) must equal the cold
    # row's; the tokens after it are reported: at bf16 with random
    # weights a 32-layer trunk leaves near-tied logits that the two
    # reads' rounding flips, and the rows then drift (PERF.md, section 6)
    if first != len(hot_tok):
        raise AssertionError(f"serve_vlm_shared: hit rows against cold: "
                             f"first {first}/{len(hot_tok)}, LCP "
                             f"{lcp}/{total}")
    return run


def serve_vlm_spec_phase(torch, kernels, serve, M, params, cfg, dev="cuda"):
    """internvl2 served speculatively on an int8 pool at VLM_SERVE
    (``spec_gamma=4``, ``quant_draft``) with ``make_draft``'s explicit
    draft of the first VLM_DRAFT_LAYERS layers, quantized to int8 by the
    engine: the draft prefills its own image prefix (the projector is
    the verify model's), every wave is an extend wave through
    ``paged_extend_attention`` (layers x waves), no wave decodes, and
    every draft forward call (counted around ``SpecDecoder``) runs its 7
    projections a layer through ``quant_matmul``."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    dcfg, dparams = make_draft(cfg, params, VLM_DRAFT_LAYERS)
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, quant_kv="int8", **SPEC,
        **VLM_SERVE), device=dev, draft=(dcfg, dparams))
    del dparams
    if eng.spec is None or eng.spec.prefix != cfg.num_image_tokens:
        raise AssertionError("serve_vlm_spec: the draft has no image prefix")
    calls = {"_decode": 0, "_prefill": 0}
    _count_calls(eng.spec, calls, calls)
    L = cfg.num_layers
    fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
        "paged_extend_attention": L * eng.extend_waves,
        "quant_matmul": 7 * VLM_DRAFT_LAYERS * sum(calls.values())},
        needs=("paged_extend_attention", "quant_matmul"),
        traffic=VLM_TRAFFIC)
    st = eng.stats()
    if st["spec_rounds"] < 1 or not st["quant_draft"] \
            or eng.decode_waves != 0:
        raise AssertionError(f"serve_vlm_spec: {st} with "
                             f"{eng.decode_waves} decode waves")
    fields.update(
        draft_layers=VLM_DRAFT_LAYERS, draft_image_prefix=eng.spec.prefix,
        draft_calls=dict(calls), verify_width=eng.K,
        spec_rounds=st["spec_rounds"], spec_proposed=st["spec_proposed"],
        spec_accepted=st["spec_accepted"],
        spec_acceptance=st["spec_acceptance"],
        acceptance_note="both models have random weights: acceptance near "
        "0 is expected and is no target",
        draft_int8_projection_bytes=_projection_bytes(eng.spec.params))
    del eng
    _release(torch)
    return fields


def serve_whisper_phase(torch, kernels, serve, M, scale="full", dev="cuda"):
    """Drive the tenth main path's encdec: whisper-base at full size
    through ``launch.serve.build_engine`` on a bf16 and an int8 pool at
    WHISPER_SERVE, WHISPER_TRAFFIC with one 1500 x 512 audio a request
    (decoder layers x decode waves through ``paged_attention``, and x
    extend waves through ``paged_extend_attention`` on int8 pages), then
    the serve CLI at its defaults; returns (the bf16 engine, cfg, phase
    fields), the launches summing all three drives."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    clock = serve.default_clock
    t0 = clock()
    cfg, eng = serve.build_engine(WHISPER_ARCH, scale,
                                  dict(WHISPER_SERVE, prefix_cache=False),
                                  dev)
    _sync(torch)
    init_s = clock() - t0
    fields = {"bf16": _extras_drive(torch, kernels, serve, M, eng, cfg,
                                    False, WHISPER_TRAFFIC, dev)}
    fields["bf16"]["init_s"] = init_s
    tokens = {r.uid: list(r.generated) for r in eng.completed}
    eng8 = EdgeServingEngine(cfg, eng.params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, quant_kv="int8",
        **WHISPER_SERVE), device=eng.device)
    int8 = _extras_drive(torch, kernels, serve, M, eng8, cfg, True,
                         WHISPER_TRAFFIC, dev)
    first, lcp, total = _int8_gate(
        {r.uid: list(r.generated) for r in eng8.completed}, tokens)
    int8.update(bf16_first_tokens_equal=f"{first}/{len(tokens)}",
                bf16_lcp_share=lcp / total)
    del eng8
    fields["int8"] = int8
    fields["cli"] = _serve_cli(torch, kernels, serve, WHISPER_CLI_ARGV,
                               cfg.num_layers)
    fields.update(arch=cfg.name, encoder_layers=cfg.encoder_layers,
                  decoder_layers=cfg.num_layers, d_model=cfg.d_model,
                  audio_frames=cfg.encoder_seq, params=cfg.param_count(),
                  weight_gb=_nbytes(eng.params) / 1e9, depth_cut=False,
                  launches={k: fields["bf16"]["launches"][k]
                            + int8["launches"][k]
                            + fields["cli"]["launches"][k] for k in kernels})
    _release(torch)
    return eng, cfg, fields


def _extras_reference_requests(cfg, request_cls) -> list:
    """Six requests of 5-150 text tokens, each with its own image or
    audio (seed 0), budgets that free slots at different waves."""
    import numpy as np
    from repro_torch.models import model as M
    rng = np.random.default_rng(0)
    key = M.EXTRAS_KEY[cfg.family]
    shape = ((cfg.num_image_tokens, cfg.image_embed_dim)
             if cfg.family == "vlm" else (cfg.encoder_seq, cfg.d_model))
    return [request_cls(uid=u, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(5, 151)), dtype=np.int32),
        max_new_tokens=n, priority=u % 3,
        extras={key: rng.normal(0, 0.1, shape).astype(np.float32)})
        for u, n in enumerate((3, 8, 2, 6, 10, 4))]


def reference_extras(torch, M, get_smoke_config, kernels, arch,
                     dev="cuda"):
    """``arch``'s smoke config at float32: the engine on the card (hand
    kernels) and on the CPU (plain versions), max_len 256, buckets to
    64 (longer prompts catch up), over ``_extras_reference_requests``.
    On a float pool the greedy tokens must be equal; on an int8 pool
    they meet the JAX int8 gate.  The card legs must have launched
    ``paged_attention`` and, on int8, ``paged_extend_attention``."""
    from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
    cfg = get_smoke_config(arch).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {"arch": arch}
    for pool in ("float32", "int8"):
        tokens = {}
        for leg, leg_dev in (("cpu", "cpu"), ("card", dev)):
            eng = EdgeServingEngine(cfg, _to(params, leg_dev), ServeConfig(
                max_slots=3, max_len=256, prefix_cache=False,
                prefill_buckets=(16, 32, 64), use_pallas_paged=True,
                quant_kv="int8" if pool == "int8" else None),
                device=leg_dev)
            _zero(kernels)
            for r in _extras_reference_requests(cfg, Request):
                eng.submit(r)
            eng.run_until_drained()
            tokens[leg] = {r.uid: list(r.generated) for r in eng.completed}
        launches = _counts(kernels)
        need = ["paged_attention"] + (["paged_extend_attention"]
                                      if pool == "int8" else [])
        out[f"{pool}_card_launches"] = launches
        if any(launches[n] == 0 for n in need) or eng.extend_waves == 0:
            raise AssertionError(f"reference {arch} {pool}: launches "
                                 f"{launches}")
        cpu, card = tokens["cpu"], tokens["card"]
        if set(card) != set(cpu) or len(cpu) != 6:
            raise AssertionError(f"reference {arch} {pool}: requests "
                                 f"{sorted(card)}")
        if pool == "float32":
            if card != cpu:
                raise AssertionError(f"reference {arch}: card tokens "
                                     f"{card} != CPU {cpu}")
            out["float32_tokens_equal"] = True
            continue
        first, lcp, total = _int8_gate(card, cpu)
        out.update(int8_first_tokens_equal=f"{first}/{len(cpu)}",
                   int8_lcp_share=lcp / total, int8_tokens_equal=card == cpu)
        if first != len(cpu) or lcp < INT8_LCP_SHARE * total:
            raise AssertionError(f"reference {arch} int8: first {first}/"
                                 f"{len(cpu)}, LCP {lcp}/{total}")
    return out


# ---------------------------------------------------------------------------
# the always-on path: the span tracer and the asyncio frontend
# ---------------------------------------------------------------------------

TRACE_SPANS = ("dispatch", "sync", "retire", "admit", "plan",
               "prefill_dispatch", "prefill_sync", "publish")
ASYNC_GAP_S = 0.02              # leg 2's arrivals, 20 ms apart
ASYNC_CANCEL_UID = 1            # cancelled after its first streamed token
ASYNC_LIMIT_S = 300.0           # every await of the frontend phase
CLI_TRACE = ROOT / "build" / "serve_async_cli_trace.json"


def _trace_checks(phase: str, tracer, n_req: int) -> list:
    """The tracer's Chrome events must validate, and every request's row
    must decompose its TTFT exactly; returns the rows."""
    from repro_torch.serving.telemetry import validate_chrome_trace
    problems = validate_chrome_trace(tracer.chrome_events())
    if problems:
        raise AssertionError(f"{phase}: trace problems {problems[:5]}")
    rows = tracer.request_summaries()
    if len(rows) != n_req:
        raise AssertionError(f"{phase}: {len(rows)} request rows")
    for r in rows:
        parts = (r["queue_wait_us"], r["prefill_us"], r["first_wave_us"])
        if None in parts or sum(parts) != r["ttft_us"]:
            raise AssertionError(f"{phase}: TTFT decomposition of request "
                                 f"{r['uid']} is not exact: {r}")
    return rows


def _trace_phases(tracer, steps: int) -> dict:
    """``summarize_trace``'s phases: per span, calls, mean and total ms,
    and ms per engine step."""
    from repro_torch.serving.telemetry import summarize_trace
    summary = summarize_trace({"traceEvents": tracer.chrome_events()})
    by = {r["name"]: r for r in summary["phases"]}
    return {name: {"calls": by[name]["calls"],
                   "mean_ms": by[name]["mean_us"] / 1e3,
                   "total_ms": by[name]["total_us"] / 1e3,
                   "ms_per_step": by[name]["total_us"] / 1e3 / steps}
            for name in TRACE_SPANS + ("step", "draft") if name in by}


def _step_split(tracer) -> dict:
    """Per wave kind (the ``dispatch`` span's mode): steps, and the mean
    ms of the step and of its dispatch, sync and retire spans, with the
    sync share of the step.  A step's child spans end before it, so the
    engine track's events since the last ``step`` are its children."""
    kinds, children = {}, []
    for ev in tracer.events:
        if ev["ph"] != "X" or ev["tid"] != 0:
            continue
        if ev["name"] != "step":
            children.append(ev)
            continue
        mode = next((c["args"]["mode"] for c in children
                     if c["name"] == "dispatch"), None)
        if mode is not None:
            agg = kinds.setdefault(mode, {"steps": 0, "step": 0.0,
                                          "dispatch": 0.0, "sync": 0.0,
                                          "retire": 0.0})
            agg["steps"] += 1
            agg["step"] += ev["dur"]
            for c in children:
                if c["name"] in agg:
                    agg[c["name"]] += c["dur"]
        children = []
    out = {}
    for mode, agg in kinds.items():
        n = agg["steps"]
        out[mode] = {"steps": n,
                     **{f"{k}_mean_ms": agg[k] / n / 1e3
                        for k in ("step", "dispatch", "sync", "retire")},
                     "sync_share": agg["sync"] / agg["step"]}
    return out


def _tracer_cost_us(n: int = 20000) -> dict:
    """Host microseconds of one traced span and of one lifecycle event
    (``req_event``) on a fresh tracer at the default clock, each the
    mean of ``n`` calls."""
    from repro_torch.serving.telemetry import Tracer, default_clock
    tr = Tracer()
    t0 = default_clock()
    for _ in range(n):
        with tr.span("x", step=0):
            pass
    t1 = default_clock()
    for i in range(n):
        tr.req_event(i % 8, "tokens", tid=10, n=1)
    t2 = default_clock()
    return {"span_us": (t1 - t0) * 1e6 / n, "event_us": (t2 - t1) * 1e6 / n}


def serve_traced_phase(torch, kernels, serve, params, cfg, serve_fields,
                       serve_tokens, dev="cuda"):
    """``serve``'s model, weights, ``ServeConfig`` and traffic with
    ``trace=True``: the same schedule, and the fences only wait for work
    the host copy waits for, so tokens and ``paged_attention`` launches
    equal ``serve``'s; the trace validates and every TTFT decomposes
    exactly.  Then the same drive untraced on a fresh engine: the
    trace's overhead is the traced ms per step less the untraced; host
    times move between drives by more than it (PERF.md §5), so beside
    it stands the tracer's own host cost (a span's and an event's
    microseconds, times the trace's spans and events a step)."""
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    L = cfg.num_layers

    def drive(trace):
        eng = EdgeServingEngine(cfg, params, ServeConfig(
            prefix_cache=False, use_pallas_paged=True, trace=trace,
            **SERVE), device=dev)
        fields = _drive(torch, kernels, serve, eng, cfg, lambda: {
            "paged_attention": L * eng.decode_waves,
            "paged_extend_attention": 0, "quant_matmul": 0, "ssd_scan": 0},
            needs=("paged_attention",))
        tokens = {r.uid: list(r.generated) for r in eng.completed}
        if tokens != serve_tokens:
            raise AssertionError(f"serve_traced (trace={trace}): tokens "
                                 "differ from serve's")
        if fields["launches"] != serve_fields["launches"] \
                or eng.decode_waves != serve_fields["decode_waves"]:
            raise AssertionError(
                f"serve_traced (trace={trace}): launches "
                f"{fields['launches']} over {eng.decode_waves} decode "
                f"waves, serve's {serve_fields['launches']}")
        return eng, fields

    eng, fields = drive(True)
    rows = _trace_checks("serve_traced", eng.tracer, N_REQ)
    _, plain = drive(False)
    cost = _tracer_cost_us()
    n_x = sum(1 for e in eng.tracer.events if e["ph"] == "X")
    n_ev = len(eng.tracer.events) - n_x
    fields.update(
        tokens_equal_serve=True,
        trace_events=len(eng.tracer.chrome_events()),
        spans=_trace_phases(eng.tracer, eng.steps),
        step_split=_step_split(eng.tracer),
        ttft_decomposition_ms={r["uid"]: [r["queue_wait_us"] / 1e3,
                                          r["prefill_us"] / 1e3,
                                          r["first_wave_us"] / 1e3]
                               for r in rows},
        ms_per_step_traced=fields["ms_per_step"],
        ms_per_step_untraced=plain["ms_per_step"],
        ms_per_step_serve=serve_fields["ms_per_step"],
        trace_overhead_ms_per_step=fields["ms_per_step"]
        - plain["ms_per_step"],
        tracer_host_cost=dict(
            cost, spans_per_step=n_x / eng.steps,
            events_per_step=n_ev / eng.steps,
            ms_per_step=(n_x * cost["span_us"] + n_ev * cost["event_us"])
            / eng.steps / 1e3),
        launches={n: fields["launches"][n] + plain["launches"][n]
                  for n in fields["launches"]})
    return fields


async def _await(fe, aw, what: str):
    """``aw`` within ASYNC_LIMIT_S; on a timeout, the frontend task's
    own error if it ended on one."""
    import asyncio
    try:
        return await asyncio.wait_for(aw, ASYNC_LIMIT_S)
    except asyncio.TimeoutError:
        task = fe._task
        if task is not None and task.done() and task.exception():
            raise AssertionError(f"serve_async: {what}: the step loop "
                                 f"failed") from task.exception()
        raise AssertionError(f"serve_async: {what}: no answer in "
                             f"{ASYNC_LIMIT_S} s")


async def _async_leg(serve, eng, reqs, gap_s: float, cancel_uid=None):
    """Serve ``reqs`` through an ``AsyncServingFrontend``: all submitted
    before the loop's first step (``gap_s`` 0) or ``gap_s`` apart;
    ``cancel_uid`` is cancelled after its first streamed token.  Returns
    (frontend, streams by uid, finished requests by uid, cancel's
    answer)."""
    import asyncio
    fe = serve.AsyncServingFrontend(eng)
    await fe.start()
    first = asyncio.Event()

    def on_token(req, tok):
        first.set()
    handles, streams = {}, {}

    async def collect(h):
        streams[h.uid] = [t async for t in h]
    collectors = []
    for i, req in enumerate(reqs):
        if i and gap_s:
            await asyncio.sleep(gap_s)
        h = fe.submit(req, on_token=on_token if req.uid == cancel_uid
                      else None)
        handles[req.uid] = h
        collectors.append(asyncio.ensure_future(collect(h)))
    cancelled = None
    if cancel_uid is not None:
        await _await(fe, first.wait(), "first token of the cancelled one")
        cancelled = await _await(fe, fe.cancel(cancel_uid), "cancel")
    done = {}
    for uid, h in handles.items():
        done[uid] = await _await(fe, h.done, f"request {uid}")
    await _await(fe, asyncio.gather(*collectors), "streams")
    await _await(fe, fe.shutdown(), "shutdown")
    if fe._task.exception() is not None:
        raise AssertionError("serve_async: the step loop failed") \
            from fe._task.exception()
    return fe, streams, done, cancelled


def serve_async_phase(torch, kernels, serve, eng0, cfg, gemma_tokens,
                      dev="cuda", cli_argv=()):
    """The CLI's default path: gemma3-1b at full width on ``serve_gemma``'s
    weights and ServeConfig (bf16 pool, kernel reads, no prefix cache),
    traced, through ``AsyncServingFrontend``.  Leg 1: every request
    submitted before the loop's first step, the drain's schedule, so the
    tokens equal ``serve_gemma``'s.  Leg 2: a fresh engine, the requests
    20 ms apart, one cancelled after its first streamed token: every
    stream equals its ``req.generated``, the cancelled request is marked
    so, no page leaks, and the trace holds ``cancel_applied``.  Each leg:
    ``paged_attention`` == global layers x decode waves.  Then
    ``launch.serve.main`` at its defaults (``--mode async``, smoke scale,
    the card) with ``--trace`` (``cli_argv`` is added to its argv)."""
    import asyncio
    import contextlib
    import io
    from repro_torch.serving import EdgeServingEngine, ServeConfig
    n_global = cfg.pattern_blocks()[0]
    n_req, _, _, max_new = GEMMA_TRAFFIC

    def leg(gap_s, cancel_uid):
        eng = EdgeServingEngine(cfg, eng0.params, ServeConfig(
            prefix_cache=False, use_pallas_paged=True, trace=True,
            **GEMMA_SERVE), device=dev)
        reqs = serve.make_requests(cfg, *GEMMA_TRAFFIC,
                                   eng.scfg.policy)
        _sync(torch)
        _zero(kernels)
        t0 = serve.default_clock()
        fe, streams, done, cancelled = asyncio.run(
            _async_leg(serve, eng, reqs, gap_s, cancel_uid))
        elapsed = serve.default_clock() - t0
        launches = _counts(kernels)
        expect = dict.fromkeys(kernels, 0)
        expect["paged_attention"] = n_global * eng.decode_waves
        if launches != expect or eng.decode_waves == 0:
            raise AssertionError(f"serve_async: launches {launches} over "
                                 f"{eng.decode_waves} decode waves")
        if sorted(done) != list(range(n_req)) or any(
                streams[u] != [int(t) for t in done[u].generated]
                for u in done):
            raise AssertionError("serve_async: a stream differs from its "
                                 "request's tokens")
        for u, r in done.items():
            if u == cancel_uid:
                if not (cancelled and r.cancelled and r.done
                        and 0 < len(r.generated) < max_new):
                    raise AssertionError(
                        f"serve_async: cancel of {u}: answer {cancelled}, "
                        f"cancelled {r.cancelled}, {len(r.generated)} "
                        "tokens")
            elif r.cancelled or len(r.generated) != max_new:
                raise AssertionError(f"serve_async: request {u}")
        _check_pool(eng, "serve_async")
        # the cancelled request streamed a first token: its row is whole
        rows = _trace_checks("serve_async", eng.tracer, n_req)
        tokens = sum(len(r.generated) for r in done.values())
        return eng, fe, done, {
            "launches": launches, "steps": eng.steps,
            "decode_waves": eng.decode_waves,
            "extend_waves": eng.extend_waves, "elapsed_s": elapsed,
            "tokens": tokens, "tok_per_s": tokens / elapsed,
            "ms_per_step": elapsed * 1e3 / eng.steps,
            "slo_stats": fe.slo_stats(),
            # the frontend's own time a step: wall time outside the
            # engine's step spans (loop, executor hop, delivery), and
            # arrival gaps when the engine is idle
            "outside_step_ms_per_step": (elapsed * 1e3 - sum(
                e["dur"] for e in eng.tracer.events
                if e["ph"] == "X" and e["name"] == "step") / 1e3)
            / eng.steps,
            "spans": _trace_phases(eng.tracer, eng.steps),
            "step_split": _step_split(eng.tracer),
            "requests_traced": len(rows)}

    eng1, _, done1, leg1 = leg(0.0, None)
    tokens1 = {u: list(r.generated) for u, r in done1.items()}
    if tokens1 != gemma_tokens:
        raise AssertionError("serve_async: leg 1's tokens differ from "
                             "serve_gemma's")
    del eng1
    eng2, fe2, done2, leg2 = leg(ASYNC_GAP_S, ASYNC_CANCEL_UID)
    applied = [e for e in eng2.tracer.chrome_events()
               if e.get("name") == "cancel_applied"]
    if len(applied) != 1 or applied[0]["args"]["uid"] != ASYNC_CANCEL_UID:
        raise AssertionError(f"serve_async: cancel_applied {applied}")
    leg2.update(cancelled_uid=ASYNC_CANCEL_UID,
                cancelled_tokens=len(done2[ASYNC_CANCEL_UID].generated),
                cancel_latency_ms=fe2.cancel_ms)
    del eng2, fe2

    # the CLI at its defaults, on the card, traced
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.telemetry import validate_chrome_trace
    out = io.StringIO()
    _zero(kernels)
    t0 = serve.default_clock()
    with contextlib.redirect_stdout(out):
        serve.main(["--trace", str(CLI_TRACE), *cli_argv])
    cli_s = serve.default_clock() - t0
    launches = _counts(kernels)
    line = json.loads(out.getvalue().splitlines()[0])
    trace = json.loads(CLI_TRACE.read_text())
    CLI_TRACE.unlink()
    events = trace["traceEvents"]
    args = serve.parse_args([])
    waves = sum(1 for e in events if e.get("name") == "dispatch"
                and e["args"]["mode"] == "decode")
    n_global_smoke = get_smoke_config(args.arch).pattern_blocks()[0]
    expect = dict.fromkeys(kernels, 0)
    expect["paged_attention"] = n_global_smoke * waves
    problems = validate_chrome_trace(events)
    if (args.mode != "async" or problems or waves == 0
            or line["requests"] != args.requests
            or line["tokens"] != args.requests * args.max_new
            or line["trace"]["events"] != len(events)
            or launches != expect):
        raise AssertionError(f"serve_async: the CLI printed {line}; trace "
                             f"problems {problems[:3]}, launches "
                             f"{launches} for {waves} decode waves")
    launches_all = {n: leg1["launches"][n] + leg2["launches"][n]
                    + launches[n] for n in launches}
    return {"arch": cfg.name, "depth": cfg.num_layers,
            "d_model": cfg.d_model, "traffic": list(GEMMA_TRAFFIC),
            "leg1_all_before_first_step": leg1,
            "leg1_tokens_equal_serve_gemma": True,
            "leg2_arrivals_20ms_apart": leg2,
            "cli": {"argv": ["--trace", "PATH"], "mode": args.mode,
                    "arch": args.arch, "scale": args.scale,
                    "line": line, "seconds": cli_s,
                    "decode_waves": waves, "launches": launches},
            "launches": launches_all}


# ---------------------------------------------------------------------------
# the hub's phases: split computing, early exit, the federated round, the
# hub deploying and serving, and the card against the CPU at smoke size
# ---------------------------------------------------------------------------

# split computing and early exit on the serve phases' phi3-medium-14b
# weights (bf16), at one inference batch of the hub's devices
SPLIT_BATCH, SPLIT_SEQ = 4, 256
# the JAX test's criterion for a cut mid-stack at 8 bits: max |split -
# full| over max |full| + 1
SPLIT_MID_REL = 0.05
# a cut at 0 or at the last layer runs the same ops as ``T.forward`` (no
# wire): equal within one bf16 rounding step of max |logit|
SPLIT_END_REL = 2 ** -8
EXIT_LAYERS = (9, 19, 29)
# the federated round: gemma3-1b at full size, float32 weights as
# ``train`` trains them; four clients offered, alice's personal data
FED_ARCH = "gemma3-1b"
FED_CLIENTS = ("alice-phone", "bob-phone", "living-room-tv",
               "bob-old-phone")
FED_ELIGIBLE = ["alice-phone", "living-room-tv"]    # tests/test_system.py
FED_BATCHES = (2, 2, 256)        # batches a client, rows, tokens
FED_KW = dict(local_steps=2, dp_clip=1.0, dp_noise_multiplier=0.01,
              secure_aggregation=True)
# the SecAgg round against the unmasked round, both without noise: the
# N(0, 1) masks are added and taken away in float32 (rounding ~1e-7 at
# |mask| < 8) before the two clients' sum is halved
FED_MASK_ATOL = 1e-6
FED_NOISE_REL = 0.01             # the added noise's std against sigma
FED_EVAL = (2, 2048)             # the held-out batch, rows x tokens
# the shared-context space (examples/shared_context.py's sizes): a
# camera and a microphone observe one of 4 events through the same
# prototypes in training and test, each view alone ambiguous
CONTEXT = dict(sensors={"cam": 32, "mic": 16}, shared=24, classes=4,
               train=512, test=256, steps=150, lr=0.1, noise=2.5)
# card against CPU at smoke size, float32 (TF32 off): the same float32
# math in another order
HUB_REF_REL = 1e-4
NEAR_TIE = 1e-4
# the days of tests/test_system.py and examples/edge_hub_serving.py:
# (streams, deadline s), (gallery batches, batch, arrival step s)
HUB_DAYS = {"test_system": ((8, 0.25), (1, 16, 0.0)),
            "edge_hub_serving": ((12, 0.2), (4, 32, 0.1))}


def _tokens(torch, vocab, rows, seq, dev, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, (rows, seq), generator=gen, device=dev)


def _wall_ms_each(torch, fns: dict, rounds: int) -> dict:
    """Median wall ms of each of ``fns`` ({name: fn}) to a synchronised
    end, the calls interleaved round by round (after one warm-up call
    each), so drifts of the host's speed fall on every one alike."""
    for fn in fns.values():
        fn()
    _sync(torch)
    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = _clock_ms()
            fn()
            _sync(torch)
            out[name].append(_clock_ms() - t0)
    return {name: sorted(v)[len(v) // 2] for name, v in out.items()}


def _wall_ms(torch, fn, reps: int = 3) -> float:
    """Median wall ms of ``fn()`` to a synchronised end (after one
    warm-up call)."""
    fn()
    _sync(torch)
    out = []
    for _ in range(reps):
        t0 = _clock_ms()
        fn()
        _sync(torch)
        out.append(_clock_ms() - t0)
    return sorted(out)[len(out) // 2]


def split_phase(torch, kernels, params, cfg, dev="cuda"):
    """Split computing on the serve phases' weights: for each non-hub
    device of ``default_home()``, ``choose_split`` at SPLIT_BATCH x
    SPLIT_SEQ (the decision printed); ``split_forward`` on seeded tokens
    at each distinct chosen cut, at the middle cut and at both ends: the
    ends equal ``T.forward`` within SPLIT_END_REL x max |logit|, a middle
    cut keeps the JAX test's criterion (SPLIT_MID_REL) at 8 bits and 4
    bits gives a larger error, the payload is ``wire_bytes``.  No kernel
    launches (the halves run the plain attention, as in JAX).  Times the
    head, the wire (quantize + dequantize) and the tail at the middle
    cut."""
    import dataclasses
    from repro_torch.core import split as SP
    from repro_torch.core.hub import default_home
    from repro_torch.models import transformer as T
    reg = default_home()
    hub = reg.get("hub")
    decisions = {}
    for name in reg.names():
        if name == "hub":
            continue
        h = reg.get(name)
        decisions[name] = dataclasses.asdict(SP.choose_split(
            cfg, h.spec, hub.spec, h.link, SPLIT_BATCH, SPLIT_SEQ))
    n = cfg.num_layers
    mid = n // 2
    cuts = sorted({d["split"] for d in decisions.values()} | {0, mid, n})
    toks = _tokens(torch, cfg.vocab_size, SPLIT_BATCH, SPLIT_SEQ, dev)
    wire = SP.wire_bytes((SPLIT_BATCH, SPLIT_SEQ, cfg.d_model), 8)
    _zero(kernels)
    res = {"arch": cfg.name, "depth": n, "d_model": cfg.d_model,
           "batch": SPLIT_BATCH, "seq": SPLIT_SEQ, "decisions": decisions,
           "cuts": cuts, "wire_bytes_8bit": wire,
           "end_tolerance": f"{SPLIT_END_REL} x max |logit|",
           "mid_tolerance": f"{SPLIT_MID_REL} x (max |logit| + 1), 8 bits"}
    with torch.no_grad():
        full = T.forward(cfg, params, toks)
        top = float(full.abs().max())
        errs = {}
        for cut in cuts:
            out, pay = SP.split_forward(cfg, params, toks, cut, bits=8)
            err = float((out - full).abs().max())
            errs[cut] = err
            end = cut in (0, n)
            if pay != (0.0 if end else wire) or not bool(
                    torch.isfinite(out).all()):
                raise AssertionError(f"split: cut {cut} payload {pay} "
                                     f"(wire {wire}) or non-finite logits")
            if (end and err > SPLIT_END_REL * top) or (
                    not end and err > SPLIT_MID_REL * (top + 1.0)):
                raise AssertionError(f"split: cut {cut} differs from "
                                     f"T.forward by {err} (max {top})")
            del out
        err4 = float((SP.split_forward(cfg, params, toks, mid, bits=4)[0]
                      - full).abs().max())
        if not err4 > errs[mid]:
            raise AssertionError(f"split: 4 bits {err4} not above 8 bits "
                                 f"{errs[mid]} at cut {mid}")
        del full
        x = SP.head_forward(cfg, params, toks, mid)

        def wire_fn():
            q, s = SP.quantize_activations(x.float(), 8)
            return SP.dequantize_activations(q, s, cfg.activation_dtype)
        times = {
            "head_ms": cuda_ms(torch, lambda i: SP.head_forward(
                cfg, params, toks, mid), iters=3, warmup=2),
            "wire_ms": cuda_ms(torch, lambda i: wire_fn(), iters=20,
                               warmup=2),
            "tail_ms": cuda_ms(torch, lambda i: SP.tail_forward(
                cfg, params, x, mid), iters=3, warmup=2)}
    launches = _counts(kernels)
    if any(launches.values()):
        raise AssertionError(f"split: kernels launched {launches}")
    res.update({"max_abs_logit": top, "max_abs_err_8bit": errs,
                "max_abs_err_4bit_mid": err4, "mid_cut": mid,
                "device_ms_mid_cut": times, "launches": launches})
    return res


def early_exit_phase(torch, kernels, params, cfg, dev="cuda"):
    """Early exit on the serve phases' weights with exit heads after
    EXIT_LAYERS: ``serve_early_exit`` at threshold 0.0 leaves every row
    at the first exit (expected layers EXIT_LAYERS[0] + 1) and at 1.1 at
    none (all layers, nothing saved); the last entry of
    ``forward_with_exits`` equals ``T.forward`` within SPLIT_END_REL x
    max |logit|; ``exit_loss`` is finite.  The eager pass's wall ms
    against the pass that never exits shows the batch skip (one host
    sync a layer).  No kernel launches."""
    from repro_torch.core import earlyexit as EE
    from repro_torch.models import transformer as T
    exits = EXIT_LAYERS
    heads = EE.init_exit_heads(cfg, exits, device=dev)
    toks = _tokens(torch, cfg.vocab_size, SPLIT_BATCH, SPLIT_SEQ, dev)
    n = cfg.num_layers
    _zero(kernels)
    with torch.no_grad():
        outs = EE.forward_with_exits(cfg, params, heads, toks)
        full = T.forward(cfg, params, toks)
        top = float(full.abs().max())
        d_last = float((outs[-1][1] - full).abs().max())
        layers = [i for i, _ in outs]
        del outs, full
        if layers != list(exits) + [n - 1] or d_last > SPLIT_END_REL * top:
            raise AssertionError(f"early_exit: exits {layers}, last entry "
                                 f"off T.forward by {d_last} (max {top})")
        loss = float(EE.exit_loss(cfg, params, heads,
                                  {"tokens": toks, "targets": toks}))
        reps = {}
        for th in (0.0, 1.1):
            r = EE.serve_early_exit(cfg, params, heads, toks, threshold=th)
            reps[th] = {"expected_layers": r.expected_layers,
                        "flops_saved_frac": r.flops_saved_frac,
                        "exit_layer": r.exit_layer.tolist(),
                        "predictions_shape": list(r.predictions.shape)}
        want = {0.0: (exits[0] + 1, 1 - (exits[0] + 1) / n), 1.1: (n, 0.0)}
        for th, (layers_, saved) in want.items():
            got = reps[th]
            if got["expected_layers"] != layers_ or abs(
                    got["flops_saved_frac"] - saved) > 1e-12:
                raise AssertionError(f"early_exit: threshold {th}: {got}")
        if not math.isfinite(loss):
            raise AssertionError(f"early_exit: exit_loss {loss}")
        eager = _wall_ms(torch, lambda: EE.serve_early_exit(
            cfg, params, heads, toks, threshold=0.0))
        never = _wall_ms(torch, lambda: EE.serve_early_exit(
            cfg, params, heads, toks, threshold=1.1))
    launches = _counts(kernels)
    if any(launches.values()):
        raise AssertionError(f"early_exit: kernels launched {launches}")
    return {"arch": cfg.name, "depth": n, "exit_layers": list(exits),
            "batch": SPLIT_BATCH, "seq": SPLIT_SEQ,
            "reports": {str(k): v for k, v in reps.items()},
            "exit_loss": loss, "last_exit_vs_forward": d_last,
            "max_abs_logit": top, "wall_ms_eager": eager,
            "wall_ms_never": never, "eager_over_never": eager / never,
            "launches": launches}


def _fed_data(cfg, dev):
    from repro_torch.configs import InputShape
    from repro_torch.data import DataConfig, data_iterator
    n_b, rows, seq = FED_BATCHES
    shape = InputShape("fl", seq, rows, "train")
    data = {}
    for i, name in enumerate(FED_CLIENTS):
        it = data_iterator(cfg, shape, DataConfig(seed=i), device=dev)
        data[name] = [next(it) for _ in range(n_b)]
    return data


def _heldout_ce(torch, M, cfg, params, dev):
    from repro_torch.data import DataConfig, synthetic_tokens
    rows, seq = FED_EVAL
    toks = torch.from_numpy(synthetic_tokens(DataConfig(seed=99),
                                             cfg.vocab_size, rows, seq,
                                             0)).to(dev)
    with torch.no_grad():
        return float(M.loss_fn(cfg, params, {"tokens": toks[:, :-1],
                                             "targets": toks[:, 1:]},
                               use_flash=True)[1]["ce"])


def _tree_diff_stats(torch, a, b):
    """(max |a - b|, mean, std) over every leaf, in float64 sums."""
    from repro_torch.training import optimizer as O
    n, s, ss, top = 0, 0.0, 0.0, 0.0
    for x, y in zip(O.tree_leaves(a), O.tree_leaves(b)):
        d = (x.float() - y.float()).double()
        n += d.numel()
        s += float(d.sum())
        ss += float((d * d).sum())
        top = max(top, float(d.abs().max()))
    mean = s / n
    return top, mean, math.sqrt(max(ss / n - mean * mean, 0.0))


def federated_phase(torch, kernels, M, dev="cuda", scale="full"):
    """The trust-zone-gated federated round on gemma3-1b (float32 weights
    from seed 0, as ``train`` trains them) through
    ``EdgeAIHub.federated_round``: alice's personal data offered to four
    clients, ``filter_devices`` keeps FED_ELIGIBLE; FedAvg + clipping +
    SecAgg + DP noise (FED_KW), each client 2 local SGD steps on its 2
    batches.  The same round without noise, and without SecAgg and
    noise: the masks cancel on the card (FED_MASK_ATOL); every client's
    clipped delta has global norm <= dp_clip; the added noise's std is
    sigma within FED_NOISE_REL.  The held-out CE before and after is
    scored through ``flash_attention`` (a launch a layer a forward); the
    rounds launch no kernel.  Returns (cfg, the round's params,
    fields)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import trustzones as tz
    from repro_torch.core.hub import EdgeAIHub
    from repro_torch.training import federated as fed
    from repro_torch.training import optimizer as O
    cfg = (get_config if scale == "full" else get_smoke_config)(FED_ARCH)
    on_card = dev != "cpu"
    if on_card:
        _sync(torch)
        torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    data = _fed_data(cfg, dev)
    hub = EdgeAIHub.create()
    item = tz.DataItem("alice-voice", "personal", "alice")
    devices = {n: (hub.registry.get(n).zone, hub.registry.get(n).owner)
               for n in FED_CLIENTS}
    eligible = tz.filter_devices(item, devices)
    if eligible != FED_ELIGIBLE:
        raise AssertionError(f"federated: eligible clients {eligible}")
    steps_ms, clip_norms = [], []
    sgd_step, clip = fed._sgd_step, fed.clip_update

    def timed_step(*a, **k):
        _sync(torch)
        t0 = _clock_ms()
        out = sgd_step(*a, **k)
        _sync(torch)
        steps_ms.append(_clock_ms() - t0)
        return out

    def recorded_clip(*a, **k):
        out = clip(*a, **k)
        clip_norms.append(float(O.global_norm(out)))
        return out

    _zero(kernels)
    rounds, round_s = {}, {}
    fed._sgd_step, fed.clip_update = timed_step, recorded_clip
    try:
        for name, kw in (("dp_secagg", FED_KW),
                         ("secagg", dict(FED_KW, dp_noise_multiplier=0.0)),
                         ("plain", dict(FED_KW, dp_noise_multiplier=0.0,
                                        secure_aggregation=False))):
            t0 = _clock_ms()
            rounds[name] = hub.federated_round(cfg, fed.FedConfig(**kw),
                                               params, data, item)
            _sync(torch)
            round_s[name] = (_clock_ms() - t0) / 1e3
    finally:
        fed._sgd_step, fed.clip_update = sgd_step, clip
    launches = _counts(kernels)
    if any(launches.values()):
        raise AssertionError(f"federated: kernels launched in a round "
                             f"{launches}")
    infos = {k: v[1] for k, v in rounds.items()}
    if any(i["clients"] != [0, 1] for i in infos.values()):
        raise AssertionError(f"federated: clients {infos}")
    if max(clip_norms) > FED_KW["dp_clip"] * (1 + 1e-5):
        raise AssertionError(f"federated: clipped norms {clip_norms}")
    mask_err = _tree_diff_stats(torch, rounds["secagg"][0],
                                rounds["plain"][0])[0]
    if mask_err > FED_MASK_ATOL:
        raise AssertionError(f"federated: the SecAgg round is {mask_err} "
                             f"off the unmasked round")
    sigma = FED_KW["dp_noise_multiplier"] * FED_KW["dp_clip"] / 2
    _, noise_mean, noise_std = _tree_diff_stats(
        torch, rounds["dp_secagg"][0], rounds["secagg"][0])
    if abs(noise_std / sigma - 1) > FED_NOISE_REL:
        raise AssertionError(f"federated: noise std {noise_std}, sigma "
                             f"{sigma}")
    new, secagg = rounds["dp_secagg"][0], rounds["secagg"][0]
    changed = sum(not torch.equal(a, b) for a, b in zip(
        O.tree_leaves(params), O.tree_leaves(new)))
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    del rounds
    _zero(kernels)
    ce = {"before": _heldout_ce(torch, M, cfg, params, dev),
          "after_dp_secagg": _heldout_ce(torch, M, cfg, new, dev),
          "after_secagg_no_noise": _heldout_ce(torch, M, cfg, secagg, dev)}
    score = _counts(kernels)
    expect = dict.fromkeys(kernels, 0)
    expect["flash_attention"] = cfg.num_layers * 3
    if score != expect or not all(math.isfinite(v) for v in ce.values()):
        raise AssertionError(f"federated: held-out scoring launches "
                             f"{score} (expected {expect}), CE {ce}")
    fields = {
        "arch": cfg.name, "depth": cfg.num_layers, "depth_cut": False,
        "params": M.count_params(new), "param_dtype": cfg.param_dtype,
        "clients_offered": list(FED_CLIENTS), "clients_kept": eligible,
        "batches_rows_tokens": FED_BATCHES, "config": FED_KW,
        "update_norms": {k: v["update_norm"] for k, v in infos.items()},
        "clipped_norms": clip_norms, "secagg_vs_plain_max_abs": mask_err,
        "mask_atol": FED_MASK_ATOL, "sigma": sigma,
        "noise_std": noise_std, "noise_mean": noise_mean,
        "leaves_changed": changed, "heldout_ce": ce,
        "heldout_rows_x_tokens": FED_EVAL,
        "local_step_ms": steps_ms, "round_s": round_s,
        "peak_mem_gb": peak, "launches": score}
    return cfg, new, fields


def _hub_drive(torch, kernels, serve, hub, name, cfg, int8: bool):
    """GEMMA_TRAFFIC through ``hub.serve(name, ...)`` and the engine's
    steps, every kernel count zeroed just before and read just after:
    ``paged_attention`` == global layers x decode waves, and on an int8
    pool ``paged_extend_attention`` == global layers x extend waves."""
    eng = hub.engines[name]
    n_global = cfg.pattern_blocks()[0]
    reqs = serve.make_requests(cfg, *GEMMA_TRAFFIC, eng.scfg.policy)
    _sync(torch)
    _zero(kernels)
    t0 = serve.default_clock()
    for r in reqs:
        hub.serve(name, r)
    while eng.queue or eng.active.any():
        eng.step()
    _sync(torch)
    elapsed = serve.default_clock() - t0
    launches = _counts(kernels)
    expect = dict.fromkeys(kernels, 0)
    expect["paged_attention"] = n_global * eng.decode_waves
    if int8:
        expect["paged_extend_attention"] = n_global * eng.extend_waves
    needs = ("paged_attention",) + (("paged_extend_attention",)
                                    if int8 else ())
    if launches != expect or any(launches[k] == 0 for k in needs):
        raise AssertionError(f"hub: {name}: launches {launches} (expected "
                             f"{expect}, none 0 of {needs})")
    _check_pool(eng, f"hub {name}")
    tokens = {r.uid: list(r.generated) for r in eng.completed}
    n_tok = sum(len(t) for t in tokens.values())
    return tokens, {
        "requests": len(tokens), "tokens": n_tok, "steps": eng.steps,
        "decode_waves": eng.decode_waves, "extend_waves": eng.extend_waves,
        "elapsed_s": elapsed, "tok_per_s": n_tok / elapsed,
        "ms_per_step": elapsed * 1e3 / eng.steps, "launches": launches}


def _hub_day(full, streams, gallery):
    """A day of the orchestrator: stream frames from the TV (priority 5,
    0.05 s apart) and gallery photo batches from alice's phone, then the
    vacuum drops out.  Returns (QoE report, the moved uids)."""
    from repro_torch.core import trustzones as tz
    from repro_torch.core.hub import EdgeAIHub
    from repro_torch.core.orchestrator import TaskSpec
    hub = EdgeAIHub.create(policy="edf")
    n_s, dl_s = streams
    n_g, batch_g, step_g = gallery
    for i in range(n_s):
        hub.submit(TaskSpec(kind="stream", model=full, batch=1, seq=256,
                            priority=5, deadline_rel=dl_s, arrival=i * 0.05,
                            source_device="living-room-tv"))
    for i in range(n_g):
        hub.submit(TaskSpec(
            kind="inference", model=full, batch=batch_g, seq=1024,
            priority=0, deadline_rel=30.0, arrival=i * step_g,
            source_device="alice-phone",
            data=tz.DataItem("gallery", "household", "alice")))
    moved = hub.orchestrator.fail_device("vacuum")
    return hub.run(), moved


def _context_data(torch, n, gen, protos):
    c = CONTEXT
    labels = torch.randint(0, c["classes"], (n,), generator=gen,
                           device=gen.device)
    views = {k: protos[k][labels] + c["noise"] * torch.randn(
        (n, d), generator=gen, device=gen.device)
        for k, d in c["sensors"].items()}
    return views, labels


def context_phase(torch, dev="cuda"):
    """The shared-context space trained for CONTEXT["steps"] SGD steps on
    the card: a camera and a microphone see one of CONTEXT["classes"]
    events through prototypes drawn once from a seed (training and test
    events alike), each view alone ambiguous; the fused accuracy on the
    test events must beat each single view's.  A second task's head
    shares the trunk."""
    from repro_torch.core import context as CX
    from repro_torch.training import optimizer as O
    c = CONTEXT
    gen = torch.Generator(device=dev).manual_seed(0)
    params = CX.init_context_space(gen, c["sensors"], c["shared"],
                                   c["classes"], device=dev)
    CX.add_task_head(params, "intent", c["classes"])
    CX.add_task_head(params, "intrusion", c["classes"])
    data_gen = torch.Generator(device=dev).manual_seed(1)
    protos = {k: torch.randn((c["classes"], d), generator=data_gen,
                             device=dev)
              for k, d in c["sensors"].items()}
    views, labels = _context_data(torch, c["train"], data_gen, protos)
    tviews, tlabels = _context_data(torch, c["test"], data_gen, protos)
    static = {k: params[k] for k in ("_key", "shared_dim", "hidden")}
    q = {k: v for k, v in params.items() if k not in static}
    losses = []
    t0 = _clock_ms()
    for _ in range(c["steps"]):
        leaves = [x.detach().requires_grad_() for x in O.tree_leaves(q)]
        loss = CX.context_loss({**O.tree_unflatten(q, leaves), **static},
                               "intent", views, labels)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        with torch.no_grad():
            q = O.sgd_update(q, O.tree_unflatten(q, grads), c["lr"])
        losses.append(float(loss.detach()))
    train_ms = _clock_ms() - t0
    params = {**q, **static}

    def acc(sub):
        with torch.no_grad():
            logits = CX.multiview_logits(params, "intent",
                                         {k: tviews[k] for k in sub})
        return float((logits.argmax(-1) == tlabels).float().mean())
    res = {"fused": acc(("cam", "mic")), "cam_only": acc(("cam",)),
           "mic_only": acc(("mic",))}
    if not res["fused"] > max(res["cam_only"], res["mic_only"]):
        raise AssertionError(f"context: fused accuracy {res}")
    with torch.no_grad():
        second = CX.multiview_logits(params, "intrusion", tviews)
    return {"sizes": c, "accuracy": res,
            "loss_first_last": [losses[0], losses[-1]],
            "train_ms": train_ms, "second_task_logits": list(second.shape),
            "device": str(second.device)}


def hub_phase(torch, kernels, serve, eng0, cfg, gemma_tokens, fed_params,
              dev="cuda"):
    """The hub's story on the card: ``EdgeAIHub.create(policy="edf")``
    deploys ``serve_gemma``'s weights as "assistant" at its settings
    (bf16 pool, kernel reads) and serves GEMMA_TRAFFIC through
    ``hub.serve``: tokens equal ``serve_gemma``'s.  The federated
    round's params, cast to the serving dtype, are deployed as
    "personal" on an int8 pool and serve the same traffic through both
    paged reads.  Then the orchestrator's days (HUB_DAYS, the vacuum
    failing) and the shared-context space (``context_phase``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.hub import EdgeAIHub
    from repro_torch.serving import ServeConfig
    hub = EdgeAIHub.create(policy="edf")
    hub.deploy_model("assistant", cfg, eng0.params, ServeConfig(
        prefix_cache=False, use_pallas_paged=True, **GEMMA_SERVE),
        device=dev)
    tokens, assistant = _hub_drive(torch, kernels, serve, hub, "assistant",
                                   cfg, False)
    if tokens != gemma_tokens:
        raise AssertionError("hub: the assistant's tokens differ from "
                             "serve_gemma's")
    launches = dict(assistant["launches"])
    hub.deploy_model("personal", cfg, serve._cast_like(fed_params,
                                                       eng0.params),
                     ServeConfig(prefix_cache=False, use_pallas_paged=True,
                                 quant_kv="int8", **GEMMA_SERVE),
                     device=dev)
    ptokens, personal = _hub_drive(torch, kernels, serve, hub, "personal",
                                   cfg, True)
    for k, v in personal["launches"].items():
        launches[k] += v
    first, lcp, total = _int8_gate(ptokens, tokens)
    personal["vs_assistant"] = {"first_equal": first, "lcp": lcp,
                                "tokens": total}
    full = get_config(FED_ARCH)
    days = {}
    for name, (streams, gallery) in HUB_DAYS.items():
        t0 = _clock_ms()
        report, moved = _hub_day(full, streams, gallery)
        days[name] = {"qoe": report, "moved": moved,
                      "host_ms": _clock_ms() - t0}
    day = days["test_system"]["qoe"]
    if day["completed"] != 9 or day["miss_rate"] > 0.25:
        raise AssertionError(f"hub: test_system's day {day}")
    del hub
    return {"arch": cfg.name, "assistant": assistant,
            "assistant_tokens_equal_serve_gemma": True,
            "personal": personal, "days": days,
            "context": context_phase(torch, dev), "launches": launches}


def reference_hub(torch, M, get_smoke_config, days, dev="cuda"):
    """The hub's pieces at smoke size, card against CPU at float32 (TF32
    off): ``split_forward`` logits at every cut of the phi3 smoke config
    within HUB_REF_REL x max; ``serve_early_exit``'s reports (exit layers
    and expected layers equal, predictions equal but at near-ties: top-2
    margins under NEAR_TIE on the CPU); ``fed_round`` without noise on
    the gemma3-1b smoke config (SecAgg on: each device draws its own
    masks, which cancel) within HUB_REF_REL x max |param| +
    FED_MASK_ATOL; the context space's logits within HUB_REF_REL x max;
    the orchestrator's day report equal to the ``hub`` phase's."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.core import context as CX
    from repro_torch.core import earlyexit as EE
    from repro_torch.core import split as SP
    from repro_torch.data import DataConfig, data_iterator
    from repro_torch.training import federated as fed
    from repro_torch.training import optimizer as Opt
    res = {"tolerance": f"{HUB_REF_REL} x max |value|"}
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(1))
    card_p, card_t = _to(params, dev), toks.to(dev)
    worst = 0.0
    with torch.no_grad():
        for cut in range(cfg.num_layers + 1):
            a = SP.split_forward(cfg, params, toks, cut)[0]
            b = SP.split_forward(cfg, card_p, card_t, cut)[0].cpu()
            worst = max(worst, float((a - b).abs().max())
                        / float(a.abs().max()))
    if worst > HUB_REF_REL:
        raise AssertionError(f"reference_hub: split logits {worst}")
    res["split_rel_err"] = worst
    heads = EE.init_exit_heads(cfg, (0,), device="cpu")
    card_h = {"exits": [_to(h, dev) for h in heads["exits"]],
              "exit_layers": heads["exit_layers"]}
    with torch.no_grad():
        outs = EE.forward_with_exits(cfg, params, heads, toks)
    conf = torch.softmax(outs[0][1], -1).amax(-1).mean(-1).sort().values
    top2 = [lg.topk(2, -1).values for _, lg in outs]
    near = torch.stack([v[..., 0] - v[..., 1] for v in top2]).amin(0) \
        < NEAR_TIE
    ee = {}
    for th in (0.0, 1.1, float(conf[1] + conf[2]) / 2):
        a = EE.serve_early_exit(cfg, params, heads, toks, th)
        b = EE.serve_early_exit(cfg, card_p, card_h, card_t, th)
        bad = a.predictions != b.predictions.cpu()
        if not torch.equal(a.exit_layer, b.exit_layer.cpu()) \
                or a.expected_layers != b.expected_layers \
                or bool((bad & ~near).any()):
            raise AssertionError(f"reference_hub: early exit at {th}")
        ee[str(th)] = {"expected_layers": b.expected_layers,
                       "predictions_differ": int(bad.sum())}
    res["early_exit"] = ee
    fcfg = get_smoke_config(FED_ARCH).replace(dtype="float32")
    fp = M.init_params(fcfg, torch.Generator().manual_seed(0), "cpu")
    shape = InputShape("fl", 32, 4, "train")
    rounds = {}
    for leg, leg_dev in (("cpu", "cpu"), ("card", dev)):
        data = {c: [next(data_iterator(fcfg, shape, DataConfig(seed=c),
                                       device=leg_dev))] for c in range(2)}
        rounds[leg] = fed.fed_round(fcfg, fed.FedConfig(
            local_steps=1, local_lr=0.3, dp_clip=1.0,
            secure_aggregation=True), _to(fp, leg_dev), data, 0)[0]
    worst = 0.0
    for a, b in zip(Opt.tree_leaves(rounds["cpu"]),
                    Opt.tree_leaves(rounds["card"])):
        err = float((a - b.cpu()).abs().max())
        if err > HUB_REF_REL * float(a.abs().max()) + FED_MASK_ATOL:
            raise AssertionError(f"reference_hub: fed_round {err}")
        worst = max(worst, err)
    res["fed_round_max_abs_err"] = worst
    c = CONTEXT
    cp = CX.init_context_space(torch.Generator().manual_seed(0),
                               c["sensors"], c["shared"], c["classes"],
                               device="cpu")
    CX.add_task_head(cp, "intent", c["classes"])
    card_cp = {"proj": _to(cp["proj"], dev), "heads": _to(cp["heads"], dev),
               "trunk_w": cp["trunk_w"].to(dev)}
    gen = torch.Generator().manual_seed(2)
    views = {k: torch.randn(64, d, generator=gen)
             for k, d in c["sensors"].items()}
    a = CX.multiview_logits(cp, "intent", views)
    b = CX.multiview_logits(card_cp, "intent", {
        k: v.to(dev) for k, v in views.items()}).cpu()
    err = float((a - b).abs().max()) / float(a.abs().max())
    if err > HUB_REF_REL:
        raise AssertionError(f"reference_hub: context logits {err}")
    res["context_rel_err"] = err
    streams, gallery = HUB_DAYS["test_system"]
    report, _ = _hub_day(get_config(FED_ARCH), streams, gallery)
    if report != days["test_system"]["qoe"]:
        raise AssertionError("reference_hub: the day's report moved")
    res["day_report_equal"] = True
    return res


# ---------------------------------------------------------------------------
# long sequences: blockwise attention, an 8192-token prompt, remat policies
# ---------------------------------------------------------------------------

# one global attention layer each (B = 1): gemma3-1b (4 heads over 1 of
# 256) at S = 8192 and at prefill_32k's 32768, phi3-medium-14b (40 over
# 10 of 128) at 8192; the plain masked softmax runs where its float32
# score tensor, its masked copy and the softmax (at most two at once)
# fit beside what the card already holds
LONG_ATTN = (("gemma3-1b", 8192), ("phi3-medium-14b", 8192),
             ("gemma3-1b", 32768))
# blockwise (and plain) against flash_attention, bf16: each route rounds
# the probabilities to bf16 before the p.v product (2**-9 relative each)
# and its output to bf16 (2**-9 each); four bf16 steps cover them with
# room, while a dropped rescale or a wrong mask moves rows by a large
# share of max |out|
LONG_REL = 2 ** -6
LONG_PLAIN_COPIES = 2.5          # score-sized float32 tensors of the plain
LONG_MEM_SHARE = 0.9             # of the card's memory a route may reach
# phi3-medium-14b serving one 8192-token prompt through an 8192 bucket:
# 32 greedy tokens, contexts to 8224 (515 pages of 16 a layer)
LONG_PROMPT, LONG_NEW = 8192, 32
LONG_SERVE = dict(max_slots=1, max_len=8240, policy="fifo",
                  prefill_buckets=(16, 32, 64, 128, 8192),
                  prefix_cache=False, use_pallas_paged=True)
# gemma3-1b's model.prefill at prefill_32k's length, B = 1: last logits
# through the blockwise branch against the use_flash route at float32
# activations (the same float32 math summed in another order), within
# LOGIT_F32_REL x max |logit|
LONG_PREFILL_GEMMA = 32768
# prefill_32k's own batch of 32 reckoned: per row, the 22 local layers'
# float32 scores (32768 / 512 windows x 4 heads x 512 x 1024) and their
# masked copy and softmax, and the MLP's three (32768, 6912) bf16
# intermediates
PREFILL_32K_ROWS = 32
# gemma3-1b train steps at S = 8192, B = 1 (4 global layers blockwise, 22
# local layers chunked), one per JAX remat policy, from the train phase's
# state; the policies that keep every activation run at the shorter
# length when the reckoning says they do not fit
REMAT_SEQ, REMAT_SEQ_SHORT = 8192, 4096
REMAT_SAVE_ALL = ("none", "everything_saveable")
REMAT_RECOMPUTE = ("nothing_saveable", "full",
                   "dots_with_no_batch_dims_saveable", "dots_saveable")
# losses across policies: equal bit for bit where cuBLAS runs the same
# algorithms in every step; else within one bf16 rounding of the loss
REMAT_LOSS_REL = 2 ** -8


# ---------------------------------------------------------------------------
# the launch layer: specs' builders on the one-card mesh, the knob, rules
# ---------------------------------------------------------------------------

# phi3-medium-14b through build_prefill at 2 x 4096 (the plain attention's
# float32 scores are 2 x 40 x 4096**2 x 4 B = 5.4 GB a layer) and through
# build_serve at 4 rows of a 4096 cache, decoding at position 1024 of a
# prompt prefilled directly
LAUNCH_PREFILL = (2, 4096)                  # rows, prompt tokens
LAUNCH_DECODE = (4, 4096, 1024)             # rows, cache length, position
LAUNCH_HOST_REPS = 10                       # decode steps timed each way
LAUNCH_TRAIN_ROUNDS = 1                     # train steps timed each way
# the knob on gemma3-1b's first global layer at S = 8192, B = 1
LAUNCH_KNOB_SEQ = 8192
LAUNCH_KNOB_SHARDS = (2, 4)
# phi3-medium-14b's param specs on the (16, 16) production mesh without
# fsdp, as the JAX package's rules give them (tests/test_torch_launch.py
# holds this table to repro.launch.sharding.param_pspecs); a rule table
# with wq's first candidate moved to head_dim must miss it
LAUNCH_GOLDEN_SPECS = {
    "embed/table": ("model", None),
    "final_norm/scale": (),
    "trunk/layers/attn/wk": (None, None, None, "model"),
    "trunk/layers/attn/wo": (None, None, None, "model"),
    "trunk/layers/attn/wq": (None, "model", None, None),
    "trunk/layers/attn/wv": (None, None, None, "model"),
    "trunk/layers/ln1/scale": (None, None),
    "trunk/layers/ln2/scale": (None, None),
    "trunk/layers/mlp/w_down": (None, "model", None),
    "trunk/layers/mlp/w_gate": (None, None, "model"),
    "trunk/layers/mlp/w_up": (None, None, "model"),
    "unembed/w": (None, "model"),
}


def _blockwise_no_rescale(torch, L, qg, k, v, scale, softcap, chunk):
    """A broken blockwise walk: the running accumulator and denominator
    are not rescaled (alpha = 1) when a later chunk raises the max."""
    B, S, K, G, hd = qg.shape
    n = S // chunk
    rel = torch.arange(chunk, device=qg.device)
    outs = []
    for qi in range(n):
        q = qg[:, qi * chunk:(qi + 1) * chunk].permute(0, 2, 3, 1, 4) \
            .reshape(B, K, G * chunk, hd).float()
        m = torch.full((B, K, G, chunk), L.NEG_INF, device=qg.device)
        l = torch.zeros((B, K, G, chunk), device=qg.device)
        acc = torch.zeros((B, K, G, chunk, hd), device=qg.device)
        for kj in range(qi + 1):
            s = torch.matmul(q, k[:, kj * chunk:(kj + 1) * chunk].permute(
                0, 2, 3, 1).float()).view(B, K, G, chunk, chunk) * scale
            s = L._softcap(s, softcap)
            vis = (kj * chunk + rel)[None, :] <= (qi * chunk + rel)[:, None]
            s = torch.where(vis, s, L.NEG_INF)
            m = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
            l = l + p.sum(dim=-1)
            acc = acc + torch.matmul(
                p.view(B, K, G * chunk, chunk),
                v[:, kj * chunk:(kj + 1) * chunk].permute(0, 2, 1, 3)
                .float()).view(B, K, G, chunk, hd)
        outs.append((acc / l[..., None]).to(qg.dtype)
                    .permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)


def _peak_gb(torch, fn):
    """(result of fn(), device GB it allocated at its peak above what
    was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def long_attention_phase(torch, kernels, timer=None, dev="cuda"):
    """One global attention layer at full width, B = 1, S = 8192 and
    32768: ``attention_fwd`` takes the blockwise branch
    (``_blockwise_inner`` walked once) and agrees with
    ``attention_fwd(use_flash=True)``; the attention core through
    ``_blockwise_causal_attention``, ``flash_attention`` and (where it
    fits) the plain masked softmax on the same q, k, v, each against the
    kernel within LONG_REL x max |out| (``_flash_inputs``' peaked q, k,
    v); a walk without the rescale shown to fail; device ms (calls back
    to back), peak GB above the inputs and the bound of each.  Kernel
    launches here compare; none is counted."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    timer = timer or cuda_ms
    on_card = dev != "cpu"
    walked = []
    inner = L._blockwise_inner

    def counted(*a, **kw):
        walked.append(a[0].shape[1])
        return inner(*a, **kw)
    out = {"tolerance": f"{LONG_REL} x max |out| of flash_attention",
           "layers": []}
    for arch, S in LONG_ATTN:
        cfg = get_config(arch)
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
        cap = cfg.attn_logit_softcap
        gen = torch.Generator(device=dev).manual_seed(S + H)
        p = L.init_attention(cfg, gen, dtype=torch.bfloat16, device=dev)
        x = torch.randn((1, S, cfg.d_model), generator=gen, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        row = {"arch": arch, "S": S, "H": H, "K": K, "hd": hd}
        with torch.no_grad():
            L._blockwise_inner = counted
            try:
                o_bw = L.attention_fwd(cfg, p, x, pos, is_global=True)[0]
            finally:
                L._blockwise_inner = inner
            o_fl = L.attention_fwd(cfg, p, x, pos, is_global=True,
                                   use_flash=True)[0]
            if walked[-1:] != [S]:
                raise AssertionError(f"long_attention {arch} S={S}: "
                                     f"attention_fwd did not walk the "
                                     f"blockwise branch ({walked})")
            top = float(o_fl.float().abs().max())
            row["attention_fwd_err"] = float((o_bw.float() - o_fl.float())
                                             .abs().max())
            if row["attention_fwd_err"] > LONG_REL * top:
                raise AssertionError(f"long_attention {arch} S={S}: "
                                     f"attention_fwd blockwise vs flash "
                                     f"{row['attention_fwd_err']} (max {top})")
            del o_bw, o_fl
            # the cores on _flash_inputs' peaked q, k, v: a key seen or
            # missed, or a rescale left out, moves rows far past LONG_REL
            q, k, v = _flash_inputs(torch, 1, S, S, H, K, hd,
                                    torch.bfloat16, seed=S + K, dev=dev)
            qg = q.view(1, S, K, H // K, hd)
            routes = {
                "blockwise": lambda: L._blockwise_causal_attention(
                    qg, k, v, scale, cap).reshape(1, S, H, hd),
                "flash_attention": lambda: ops.flash_attention(
                    q, k, v, scale=scale, window=0, softcap=cap)}
            score_bytes = H * S * S * 4
            total = (torch.cuda.get_device_properties(0).total_memory
                     if on_card else float("inf"))
            resident = torch.cuda.memory_allocated() if on_card else 0
            row["plain_reckoned_gb"] = (LONG_PLAIN_COPIES * score_bytes
                                        + resident) / 1e9
            if LONG_PLAIN_COPIES * score_bytes + resident \
                    <= LONG_MEM_SHARE * total:
                routes["plain"] = lambda: L.attention_weights_and_out(
                    qg, k, v, L.causal_mask(S, S, device=dev)[None, None,
                                                                None],
                    scale=scale, softcap=cap).reshape(1, S, H, hd)
            iters = 3 if S > 8192 else 10
            got = {}
            for name, fn in routes.items():
                if on_card:
                    got[name], peak = _peak_gb(torch, fn)
                else:
                    got[name], peak = fn(), None
                row[name] = {"peak_gb": peak,
                             "ms": timer(torch, lambda i, fn=fn: fn(),
                                         iters=iters, warmup=2)}
            want = got["flash_attention"].float()
            top = float(want.abs().max())
            for name in got:
                err = float((got[name].float() - want).abs().max())
                row[name]["max_abs_err"] = err
                if err > LONG_REL * top:
                    raise AssertionError(f"long_attention {arch} S={S}: "
                                         f"{name} vs flash_attention {err} "
                                         f"(max {top})")
            row["max_abs_out"] = top
            if "plain" not in routes:
                row["plain"] = (f"not run: reckoned "
                                f"{row['plain_reckoned_gb']:.1f} GB over "
                                f"{LONG_MEM_SHARE} x the card's memory")
            if arch == "gemma3-1b" and S == 8192:
                broken = _blockwise_no_rescale(torch, L, qg, k, v, scale,
                                               cap, L.BLOCKWISE_CHUNK)
                row["broken_no_rescale_err"] = float(
                    (broken.reshape(1, S, H, hd).float() - want).abs().max())
                if row["broken_no_rescale_err"] <= LONG_REL * top:
                    raise AssertionError(f"long_attention: a walk without "
                                         f"the rescale passes "
                                         f"({row['broken_no_rescale_err']})")
            del got, want, q, k, v, qg, routes
        bound, by, ops_n = _flash_bound(1, S, S, H, K, hd, 0, 2, "bfloat16")
        row.update(bound_ms=bound, bound_by=by, causal_ops=ops_n)
        out["layers"].append(row)
        del p, x
        if on_card:
            _release(torch)
    return out


def _logit_margin(logits):
    top2 = logits.float().topk(2).values
    return float(top2[0] - top2[1])


def long_prefill_phase(torch, kernels, serve, M, params, cfg, dev="cuda",
                       gemma_scale="full"):
    """The eleventh main path: phi3-medium-14b (the serve phases'
    weights) serving one 8192-token prompt through the paged engine with
    an 8192 prefill bucket: the admission prefill walks the blockwise
    branch in every layer, 32 greedy tokens decode through
    ``paged_attention`` at contexts to 8224 (launches == 40 x decode
    waves, counted from 0), the first token is the argmax of
    ``model.apply(use_flash=True)``'s last row (the margin printed); TTFT
    and ms a decode step.  Then gemma3-1b's ``model.prefill`` at 32768
    tokens, B = 1, through the blockwise branch against the use_flash
    route: float32 last logits within LOGIT_F32_REL x max |logit|, bf16
    times; prefill_32k's batch of 32 reckoned against the card."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
    clock = serve.default_clock
    on_card = dev != "cpu"
    gen = torch.Generator(device="cpu").manual_seed(27)
    prompt = torch.randint(0, cfg.vocab_size, (LONG_PROMPT,),
                           generator=gen).numpy().astype("int32")
    eng = EdgeServingEngine(cfg, params, ServeConfig(**LONG_SERVE),
                            device=dev)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    req = Request(uid=0, prompt=prompt, max_new_tokens=LONG_NEW)
    _zero(kernels)
    eng.submit(req)
    t0 = clock()
    while not req.generated:
        eng.step()
    _sync(torch)
    ttft_ms = (clock() - t0) * 1e3
    steps = []
    while not req.done:
        t1 = clock()
        eng.step()
        _sync(torch)
        steps.append((clock() - t1) * 1e3)
    launches = _counts(kernels)
    expect = dict.fromkeys(kernels, 0)
    expect["paged_attention"] = cfg.num_layers * eng.decode_waves
    if launches != expect or not launches["paged_attention"] \
            or len(req.generated) != LONG_NEW:
        raise AssertionError(f"long_prefill: launches {launches} for "
                             f"{eng.decode_waves} decode waves (expected "
                             f"{expect}); {len(req.generated)} tokens")
    _check_pool(eng, "long_prefill")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    del eng
    if on_card:
        _release(torch)
    with torch.no_grad():
        logits = M.apply(cfg, params, {"tokens": torch.from_numpy(
            prompt[None]).to(dev)}, use_flash=True)[0][0, -1]
    first = int(logits.argmax())
    margin = _logit_margin(logits)
    if req.generated[0] != first:
        raise AssertionError(f"long_prefill: first token {req.generated[0]}"
                             f" against the use_flash route's {first} "
                             f"(margin {margin})")
    res = {"arch": cfg.name, "depth": cfg.num_layers, "prompt": LONG_PROMPT,
           "new_tokens": LONG_NEW, "serve": LONG_SERVE,
           "ttft_ms": ttft_ms, "decode_ms_per_step": sum(steps) / len(steps),
           "decode_steps": len(steps), "decode_waves": expect[
               "paged_attention"] // cfg.num_layers,
           "launches": launches, "peak_mem_gb": peak,
           "first_token": first, "first_token_logit_margin": margin,
           "tokens": list(req.generated)}

    # gemma3-1b's prefill at prefill_32k's length
    gcfg = (get_config if gemma_scale == "full" else get_smoke_config)(
        "gemma3-1b")
    gcfg = gcfg.replace(param_dtype=gcfg.dtype)
    gparams = M.init_params(gcfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    S = LONG_PREFILL_GEMMA
    toks = _tokens(torch, gcfg.vocab_size, 1, S, dev, seed=32)
    prefill = {}
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            c = gcfg.replace(dtype=dtype)
            for flash in (False, True):
                t0 = clock()
                lg = M.prefill(c, gparams, {"tokens": toks}, S,
                               use_flash=flash)[0]
                _sync(torch)
                prefill[(dtype, flash)] = (lg.float()[0, -1],
                                           (clock() - t0) * 1e3)
    (bw, bw_ms), (fl, fl_ms) = prefill[("float32", False)], \
        prefill[("float32", True)]
    top = float(fl.abs().max())
    err = float((bw - fl).abs().max())
    if err > LOGIT_F32_REL * top or not bool(torch.isfinite(bw).all()):
        raise AssertionError(f"long_prefill: gemma3-1b S={S} blockwise "
                             f"last logits {err} from the use_flash "
                             f"route's (max {top})")
    hb, hf = prefill[("bfloat16", False)][0], prefill[("bfloat16", True)][0]
    # prefill_32k's batch: the local layers' scores, their masked copy
    # and softmax in float32, and the MLP's three bf16 intermediates
    W = gcfg.local_window
    row_bytes = (3 * (S // W) * gcfg.num_heads * W * 2 * W * 4
                 + 3 * S * gcfg.d_ff * 2)
    total = (torch.cuda.get_device_properties(0).total_memory if on_card
             else float("inf"))
    reckoned = PREFILL_32K_ROWS * row_bytes + (
        torch.cuda.memory_allocated() if on_card else 0)
    batch_ms = None
    if reckoned <= LONG_MEM_SHARE * total:
        rows = toks.expand(PREFILL_32K_ROWS, S)
        with torch.no_grad():
            t0 = clock()
            M.prefill(gcfg, gparams, {"tokens": rows}, S)
            _sync(torch)
            batch_ms = (clock() - t0) * 1e3
    res["gemma_prefill"] = {
        "S": S, "B": 1, "f32_last_logits_err": err, "f32_max_logit": top,
        "f32_tolerance": f"{LOGIT_F32_REL} x max |logit|",
        "f32_ms_blockwise": bw_ms, "f32_ms_flash": fl_ms,
        "bf16_ms_blockwise": prefill[("bfloat16", False)][1],
        "bf16_ms_flash": prefill[("bfloat16", True)][1],
        "bf16_last_logits_err": float((hb - hf).abs().max()),
        "bf16_argmax_equal": int(hb.argmax()) == int(hf.argmax()),
        "prefill_32k_batch": PREFILL_32K_ROWS,
        "prefill_32k_reckoned_gb": reckoned / 1e9,
        "prefill_32k_bf16_ms": batch_ms if batch_ms is not None else (
            f"not run: reckoned {reckoned / 1e9:.0f} GB over "
            f"{LONG_MEM_SHARE} x {total / 1e9:.0f} GB")}
    del gparams, prefill
    return res


def _saved_bytes(torch, fn, exclude) -> int:
    """Bytes of the distinct storages autograd saves for the backward
    of ``fn()`` (those of ``exclude``, the weights, left out)."""
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in exclude:
            seen[s.data_ptr()] = s.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    del out
    return sum(seen.values())


def train_remat_phase(torch, kernels, M, cfg, state, dev="cuda"):
    """One gemma3-1b train step at S = 8192, B = 1 under each JAX remat
    policy from the train phase's state (float32 weights and AdamW
    moments, bf16 activations; the 4 global layers blockwise, the 22
    local layers chunked): loss, grad norm, step ms and peak GB.  The
    policies that keep every activation run at REMAT_SEQ_SHORT beside
    ``full`` when the reckoning (``nothing_saveable``'s measured peak
    plus the bytes autograd saves for one local and one global layer,
    times their counts) says they do not fit.  The losses at one length
    are equal (bit for bit, or within REMAT_LOSS_REL, the script says
    which).  No kernel launches (no kernel has a backward)."""
    from repro_torch.data import DataConfig, synthetic_tokens
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer as TR
    clock = _clock_ms
    on_card = dev != "cpu"
    ocfg = O.OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=3)

    def batch(S):
        t = torch.from_numpy(synthetic_tokens(DataConfig(seed=3, branching=4),
                                              cfg.vocab_size, 1, S, 0))
        t = t.to(dev)
        return {"tokens": t[:, :-1], "targets": t[:, 1:]}

    def step(policy, S):
        fn = TR.make_train_step(cfg, TR.TrainConfig(
            optimizer=ocfg, microbatches=1, remat=policy))
        b = batch(S)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = clock()
        new, m = fn(state, b)
        _sync(torch)
        ms = clock() - t0
        res = {"policy": policy, "seq": S, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "step_ms": ms,
               "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if on_card else None)}
        del new, m
        if on_card:
            _release(torch)
        return res

    _zero(kernels)
    runs = [step(p, REMAT_SEQ) for p in REMAT_RECOMPUTE]
    # the reckoning for the policies that keep every activation
    order = _trunk_order(cfg, state["params"]["trunk"])
    weights = {t.untyped_storage().data_ptr()
               for t in O.tree_leaves(state["params"])}
    b = batch(REMAT_SEQ)
    x = L.embed(cfg, state["params"]["embed"], b["tokens"])
    pos = torch.arange(REMAT_SEQ, dtype=torch.int32, device=dev)[None]
    per = {}
    for lp, is_global in order:
        if is_global not in per:
            per[is_global] = _saved_bytes(torch, lambda: T.block_fwd(
                cfg, lp, x, pos, is_global=is_global), weights)
    n_global = sum(g for _, g in order)
    keep_all = per[True] * n_global + per[False] * (len(order) - n_global)
    ns_peak = runs[0]["peak_mem_gb"] or 0.0
    reckoned = ns_peak + keep_all / 1e9
    total = (torch.cuda.get_device_properties(0).total_memory / 1e9
             if on_card else float("inf"))
    fits = reckoned <= LONG_MEM_SHARE * total
    del x, b
    S_all = REMAT_SEQ if fits else REMAT_SEQ_SHORT
    runs += [step(p, S_all) for p in REMAT_SAVE_ALL]
    if not fits:
        runs.append(step("full", S_all))
    launches = _counts(kernels)
    if any(launches.values()):
        raise AssertionError(f"train_remat: kernel launches {launches}")
    agree = {}
    for S in sorted({r["seq"] for r in runs}):
        losses = [r["loss"] for r in runs if r["seq"] == S]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train_remat: non-finite loss {runs}")
        exact = len(set(losses)) == 1
        spread = max(losses) - min(losses)
        if spread > REMAT_LOSS_REL * abs(losses[0]):
            raise AssertionError(f"train_remat: losses at S={S} differ by "
                                 f"{spread}: {runs}")
        agree[S] = "bitwise equal" if exact else (
            f"within {REMAT_LOSS_REL} relative (spread {spread})")
    return {"arch": cfg.name, "rows": 1, "runs": runs,
            "losses_agree": agree, "launches": launches,
            "keep_all_reckoned_gb": reckoned,
            "keep_all_reckoning": (f"nothing_saveable's peak {ns_peak:.2f} GB"
                                   f" + saved bytes per layer (global "
                                   f"{per[True] / 1e9:.3f} GB x {n_global}, "
                                   f"local {per[False] / 1e9:.3f} GB x "
                                   f"{len(order) - n_global})"),
            "keep_all_seq": S_all,
            "keep_all_note": ("none and everything_saveable ran at "
                              f"S={S_all}" + ("" if fits else
                                              ": the reckoning is over "
                                              f"{LONG_MEM_SHARE} x the "
                                              "card's memory"))}


def _peak(torch, fn, on_card: bool):
    """``_peak_gb`` on the card; (fn(), None) elsewhere."""
    return _peak_gb(torch, fn) if on_card else (fn(), None)


def _on_dtensors(sh, mesh, shardings, args):
    """``args`` laid out as DTensors on ``mesh`` by ``shardings`` even
    where the mesh has one device (``sharding.place`` keeps those plain):
    the route whose host cost the one-device bypass saves."""
    return tuple(sh.distribute(a, mesh, s) for a, s in zip(args, shardings))


def _roofline_of(torch, hlo, rl, fn, args, cfg, shape, device_ms) -> dict:
    """``roofline.analyze`` of one traced call of ``fn(*args)`` on the
    one-card mesh, beside the step's measured device ms."""
    with hlo.Trace() as traced:
        fn(*args)
    _sync(torch)
    traced.arg_bytes = hlo.shape_bytes(list(args))
    r = rl.analyze(traced, arch=cfg.name, shape_name=shape.name,
                   mesh_name="local (1, 1)", chips=1,
                   model_flops=rl.model_flops_for(cfg, shape))
    return {"compute_ms": r.compute_s * 1e3, "memory_ms": r.memory_s * 1e3,
            "collective_ms": r.collective_s * 1e3,
            "bottleneck": r.bottleneck, "useful_ratio": r.useful_ratio,
            "flops": r.hlo_flops_per_chip, "bytes": r.hlo_bytes_per_chip,
            "collectives": r.coll_counts,
            "trace_peak_gb": r.temp_bytes_per_chip / 1e9,
            "measured_device_ms": device_ms}


def _busy_ms(torch, fn, on_card: bool):
    if not on_card:
        return "not measured"
    prof = _device_profile(torch, fn)
    return prof.get("device_busy_ms", prof.get("device_ms"))


def launch_serve_phase(torch, kernels, M, params, cfg, dev="cuda",
                       prefill=LAUNCH_PREFILL, decode=LAUNCH_DECODE):
    """phi3-medium-14b's serving steps through the launch layer on its
    ``serve`` weights: ``specs.build_prefill`` at (rows, prompt) =
    ``prefill`` and ``specs.build_serve`` at ``decode``'s rows and cache
    length, on ``mesh.make_local_mesh`` (NCCL, world size 1).  The built
    prefill's last logits and cache, and one built decode step's logits
    and cache, are bit for bit those of ``model.prefill`` /
    ``model.decode_step`` called directly on the same inputs, greedy
    tokens equal.  Device ms and peak GB of each route; the decode step's
    wall ms each way and on DTensors over the same mesh (``_on_dtensors``:
    DTensor's host cost, which the one-device mesh's plain tensors do
    not pay), its logits bit for bit too; the roofline of each built step
    from its own trace.  No kernel launches (the builders pass no kernel
    switch, as JAX's)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils._pytree import tree_map

    from repro_torch.launch import sharding as sh
    from repro_torch.configs import InputShape
    from repro_torch.launch import hlo_analysis as hlo
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_local_mesh
    on_card = dev != "cpu"
    mesh = make_local_mesh(dev)
    _zero(kernels)
    fields = {"arch": cfg.name, "mesh": str(mesh)}
    with torch.no_grad():
        B, S = prefill
        shape = InputShape("launch_prefill", S, B, "prefill")
        built = sp.build_prefill(cfg, shape, mesh)
        batch = {"tokens": _tokens(torch, cfg.vocab_size, B, S, dev,
                                   seed=5).int()}
        (lb, cb), peak_b = _peak(torch, lambda: built.fn(params, batch),
                                 on_card)
        (ld, cd), peak_d = _peak(
            torch, lambda: M.prefill(cfg, params, batch, S), on_card)
        pre = {"rows": B, "tokens": S,
               # one layer's float32 scores, reckoned from the shapes
               "scores_gb_reckoned": B * cfg.num_heads * S * S * 4 / 1e9,
               "logits_equal": bool(torch.equal(lb, ld)),
               "cache_equal": _tree_equal(torch, cb, cd),
               "greedy_equal": bool(torch.equal(lb.argmax(-1),
                                                ld.argmax(-1))),
               "peak_gb": {"built": peak_b, "direct": peak_d}}
        del lb, cb, ld, cd
        pre["device_ms"] = {
            "built": _busy_ms(torch, lambda: built.fn(params, batch),
                              on_card),
            "direct": _busy_ms(torch, lambda: M.prefill(cfg, params, batch,
                                                        S), on_card)}
        pre["roofline"] = _roofline_of(torch, hlo, rl, built.fn,
                                       (params, batch), cfg, shape,
                                       pre["device_ms"]["built"])
        fields["prefill"] = pre
        if on_card:
            _release(torch)

        B, T, P = decode
        shape = InputShape("launch_decode", T, B, "decode")
        built = sp.build_serve(cfg, shape, mesh)
        prompt = {"tokens": _tokens(torch, cfg.vocab_size, B, P, dev,
                                    seed=6).int()}
        logits0, cache = M.prefill(cfg, params, prompt, T)
        tok = logits0[:, -1:].argmax(-1).int()
        pos = torch.full((B,), P, dtype=torch.int32, device=dev)
        cache_d = tree_map(torch.clone, cache)
        (lb, cb), peak_b = _peak(
            torch, lambda: built.fn(params, cache, tok, pos), on_card)
        (ld, _), peak_d = _peak(
            torch, lambda: M.decode_step(cfg, params, cache_d, tok, pos),
            on_card)
        dec = {"rows": B, "cache_len": T, "position": P,
               "logits_equal": bool(torch.equal(lb, ld)),
               "cache_equal": _tree_equal(torch, cb, cache_d),
               "greedy_equal": bool(torch.equal(lb.argmax(-1),
                                                ld.argmax(-1))),
               "peak_gb": {"built": peak_b, "direct": peak_d}}
        # the same token at the same position again: the same writes
        step_b = lambda: built.fn(params, cache, tok, pos)  # noqa: E731
        step_d = lambda: M.decode_step(  # noqa: E731
            cfg, params, cache_d, tok, pos)
        dt = _on_dtensors(sh, mesh, built.in_shardings,
                          (params, tree_map(torch.clone, cache), tok, pos))

        def step_t():
            with implicit_replication():
                return M.decode_step(cfg, *dt)
        dec["dtensor_logits_equal"] = bool(torch.equal(
            sh.gather(step_t()[0]), ld))
        del lb, cb, ld
        dec["wall_ms"] = _wall_ms_each(
            torch, {"built": step_b, "direct": step_d, "dtensor": step_t},
            LAUNCH_HOST_REPS)
        dec["device_ms"] = {"built": _busy_ms(torch, step_b, on_card),
                            "direct": _busy_ms(torch, step_d, on_card),
                            "dtensor": _busy_ms(torch, step_t, on_card)}
        dec["roofline"] = _roofline_of(
            torch, hlo, rl, built.fn, (params, cache, tok, pos), cfg, shape,
            dec["device_ms"]["built"])
        fields["decode"] = dec
        del cache, cache_d, logits0, dt
    bad = [f"{k}.{c}" for k in ("prefill", "decode")
           for c in ("logits_equal", "cache_equal", "greedy_equal")
           if not fields[k][c]]
    if not fields["decode"]["dtensor_logits_equal"]:
        bad.append("decode.dtensor_logits_equal")
    if bad:
        raise AssertionError(f"launch_serve: built steps differ from the "
                             f"direct calls: {bad} {fields}")
    fields["launches"] = _counts(kernels)
    if any(fields["launches"].values()):
        raise AssertionError(f"launch_serve: kernel launches "
                             f"{fields['launches']}")
    return fields


def _flat_specs(tree) -> dict:
    from torch.utils._pytree import tree_leaves_with_path
    return {"/".join(e.key for e in path): tuple(s)
            for path, s in tree_leaves_with_path(tree)}


def launch_specs_check(M, get_config) -> dict:
    """phi3-medium-14b's param specs on the (16, 16) production mesh
    (an ``AbstractMesh``: no process group) equal ``LAUNCH_GOLDEN_SPECS``;
    a rule table with wq's first candidate moved to head_dim is shown to
    miss it."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import abstract_mesh
    cfg = get_config(ARCH)
    mesh = abstract_mesh((16, 16), ("data", "model"))
    shapes = sp.shapes(M.init_params(cfg, None, "meta"))
    got = _flat_specs(sh.param_pspecs(cfg, mesh, shapes))
    if got != LAUNCH_GOLDEN_SPECS:
        raise AssertionError(f"launch: phi3 specs {got} != "
                             f"{LAUNCH_GOLDEN_SPECS}")
    rules = sh._PARAM_RULES
    sh._PARAM_RULES = dict(rules, wq=([(-1, "model"), (-3, "model")],
                                      rules["wq"][1]))
    try:
        broken = _flat_specs(sh.param_pspecs(cfg, mesh, shapes))
    finally:
        sh._PARAM_RULES = rules
    missed = sorted(k for k, v in LAUNCH_GOLDEN_SPECS.items()
                    if broken[k] != v)
    if not missed:
        raise AssertionError("launch: a broken rule table gave the golden "
                             "specs")
    return {"phi3_specs_equal_golden": True,
            "broken_rule_table": "wq's first candidate moved from heads "
                                 "(-2) to head_dim (-1)",
            "broken_table_misses": {k: broken[k] for k in missed}}


def _dtensor_train_step(torch, sh, TR, built, mesh, cfg, tcfg, state,
                        batch) -> dict:
    """One train step of ``built`` (plain tensors on the one-card mesh)
    and the same step on DTensors over that mesh (``_on_dtensors``):
    loss and grad norm bit for bit equal, and the median wall ms each way
    over LAUNCH_TRAIN_ROUNDS interleaved rounds (DTensor's host cost)."""
    from torch.distributed.tensor.experimental import implicit_replication
    dt = _on_dtensors(sh, mesh, built.in_shardings, (state, batch))
    step = TR.make_train_step(cfg, tcfg)

    def on_dtensors():
        with implicit_replication():
            return step(*dt)
    mp = built.fn(state, batch)[1]
    md = sh.gather(on_dtensors()[1])
    equal = {k: float(mp[k]) == float(md[k]) for k in ("loss", "grad_norm")}
    if not all(equal.values()):
        raise AssertionError(f"launch: the train step on DTensors differs "
                             f"from the plain one: {equal} {mp} {md}")
    return {"equal": equal, "wall_ms": _wall_ms_each(
        torch, {"plain": lambda: built.fn(state, batch),
                "dtensor": on_dtensors}, LAUNCH_TRAIN_ROUNDS)}


def launch_phase(torch, kernels, train, M, cfg, state, train_device_ms,
                 argv=TRAIN_ARGV, dev="cuda", knob_seq=LAUNCH_KNOB_SEQ):
    """The launch layer on gemma3-1b's trained state (after
    ``train_remat``): ``layers.SEQ_PARALLEL_ATTN`` set by hand to each of
    ``LAUNCH_KNOB_SHARDS`` on the first global layer at S = ``knob_seq``
    against the unset walk (bit for bit, else within LONG_REL x max
    |out|; the shard offsets seen by ``_blockwise_inner`` recorded); the
    roofline of ``specs.build_train``'s step at the train phase's shape
    from its own trace beside ``train_device_ms`` (the device-busy ms of
    the train phase's profiled step: the same built step and shape, so
    it is not profiled twice); the same step on DTensors over the mesh
    (``_dtensor_train_step``: DTensor's host cost); the sharding rules
    against ``LAUNCH_GOLDEN_SPECS`` with a broken table shown to fail.
    No kernel launches."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import DataConfig, data_iterator
    from repro_torch.launch import hlo_analysis as hlo
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.training import trainer as TR
    _zero(kernels)
    lp = next(p for p, g in _trunk_order(cfg, state["params"]["trunk"])
              if g)["attn"]
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((1, knob_seq, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.float32).to(cfg.activation_dtype)
    pos = torch.arange(knob_seq, dtype=torch.int32, device=dev)[None]
    attend = lambda: L.attention_fwd(  # noqa: E731
        cfg, lp, x, pos, is_global=True)[0]
    inner = L._blockwise_inner
    offsets = []

    def recording(*a, q_offset=0, **k):
        offsets.append(q_offset)
        return inner(*a, q_offset=q_offset, **k)
    knob = []
    with torch.no_grad():
        base = attend()
        base_ms = _wall_ms(torch, attend, 3)
        bound = LONG_REL * float(base.float().abs().max())
        for n in LAUNCH_KNOB_SHARDS:
            L.SEQ_PARALLEL_ATTN = (n, None)
            L._blockwise_inner = recording
            try:
                offsets.clear()
                out = attend()
                seen = sorted(set(offsets))
                L._blockwise_inner = inner
                ms = _wall_ms(torch, attend, 3)
            finally:
                L.SEQ_PARALLEL_ATTN = None
                L._blockwise_inner = inner
            diff = float((out.float() - base.float()).abs().max())
            row = {"shards": n, "q_offsets": seen,
                   "bitwise_equal": bool(torch.equal(out, base)),
                   "max_abs_diff": diff, "bound": bound, "ms": ms}
            knob.append(row)
            if len(seen) != n or (not row["bitwise_equal"] and diff > bound):
                raise AssertionError(f"launch: the knob at n={n}: {row}")
        del base, out, x
    fields = {"arch": cfg.name,
              "knob": {"layer": "first global", "seq": knob_seq,
                       "unset_ms": base_ms, "rows": knob}}

    args = train.parse_args([*argv, "--device", dev])
    shape = InputShape("cli", args.seq, args.batch, "train")
    mesh = make_local_mesh(dev)
    built = sp.build_train(cfg, shape, mesh, train.train_config(args))
    batch = next(data_iterator(cfg, shape, DataConfig(branching=4),
                               device=dev))
    fields["train_step_roofline"] = _roofline_of(
        torch, hlo, rl, built.fn, (state, batch), cfg, shape,
        train_device_ms)
    fields["dtensor_train_step"] = _dtensor_train_step(
        torch, sh, TR, built, mesh, cfg, train.train_config(args), state,
        batch)
    del batch
    fields["specs"] = launch_specs_check(M, get_config)
    fields["launches"] = _counts(kernels)
    if any(fields["launches"].values()):
        raise AssertionError(f"launch: kernel launches {fields['launches']}")
    return fields


def _to(tree, dev):
    """A copy of ``tree`` on ``dev`` whose leaves are new tensor objects
    (``detach``), so flags set on them leave ``tree`` as it was."""
    return {k: (_to(v, dev) if isinstance(v, dict) else v.detach().to(dev))
            for k, v in tree.items()}


# the dry-run's full-size routes through the model layer's explicit
# DTensor layouts (tests/test_torch_dryrun_grid.py traces the same)
DRYRUN_PAIRS = (("whisper-base", "train_4k", "multi"),
                ("gemma3-27b", "decode_32k", "single"),
                ("mamba2-370m", "prefill_32k", "single"),
                ("granite-moe-1b-a400m", "train_4k", "single"),
                ("gemma3-1b", "prefill_32k", "single"))
# the smoke-size fake traces of the routes some torch versions' DTensor
# rules refuse unless the model lays them out itself
DRYRUN_TRACES = ("moe_pod_data_granite", "prefill_ring_three_axis",
                 "train_three_axis_kimi")
DRYRUN_TIMEOUT_S = 90


def dryrun_phase(pairs=DRYRUN_PAIRS, traces=DRYRUN_TRACES,
                 timeout=DRYRUN_TIMEOUT_S) -> dict:
    """Each (arch, shape, mesh) of ``pairs`` through the port's dry-run
    CLI, one subprocess each, and ``traces``, cases of
    ``tests/test_torch_sharded.py``'s smoke-size fake traces on a fake
    world of four, in one more, all started together; the records, read
    back from files under ``build/``, and each trace's status.  Raises
    unless every record and trace is ``ok``."""
    from repro_torch.serving.telemetry import default_clock as clock
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    t0 = clock()
    procs = []
    for arch, shape, mesh in pairs:
        out = out_dir / f"{arch}-{shape}-{mesh}.jsonl"
        out.unlink(missing_ok=True)
        procs.append((arch, shape, mesh, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT)))
    traced = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "test_torch_sharded.py"),
         "traces", *traces], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    records, bad = [], []
    try:
        for arch, shape, mesh, out, p in procs:
            log = p.communicate(timeout=max(
                1.0, timeout - (clock() - t0)))[0]
            rec = (json.loads(out.read_text().splitlines()[0])
                   if out.exists() else {"status": "missing"})
            row = {"arch": arch, "shape": shape, "mesh": mesh,
                   "status": rec["status"], "rc": p.returncode,
                   "hlo_flops_per_chip": rec.get("hlo_flops_per_chip"),
                   "coll_bytes_per_chip": rec.get("coll_bytes_per_chip"),
                   "trace_s": rec.get("trace_s")}
            records.append(row)
            if rec["status"] != "ok":
                bad.append(dict(row, error=rec.get("error"),
                                log=log[-1500:]))
        log = traced.communicate(timeout=max(
            1.0, timeout - (clock() - t0)))[0]
        try:
            traced_ok = json.loads(log.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            traced_ok = {"all": {"ok": False, "error": log[-1500:]}}
        bad += [{"trace": k, **v} for k, v in traced_ok.items()
                if not v["ok"]]
        bad += [{"trace": k, "missing": True} for k in traces
                if k not in traced_ok]
    finally:
        for p in [p for *_, p in procs] + [traced]:
            if p.poll() is None:
                p.kill()
                p.wait()
    if bad:
        raise AssertionError(f"dry-run records not ok: {bad}")
    return {"records": records, "traces_ok": sorted(traced_ok),
            "wall_s": clock() - t0}


def main() -> int:
    # internvl2's phases hold 60-72 GB of the card's 80; with fixed-size
    # segments 11.65 GB of them sat free in pieces too small for
    # model_vlm's 3.91 GB float32 unembedding, and the run failed there.
    # Growable segments keep the free space whole (read before the first
    # allocation; switching later did not help).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_extend_attention as pea
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import close_mesh
    from repro_torch.models import model as M
    from repro_torch.models import ssm

    clock = serve.default_clock
    t_start = clock()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    idle_w = idle_power_w()
    kind = torch.cuda.get_device_name(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=kind, nvidia_smi=smi, idle_power_draw_w=idle_w,
         python=sys.version.split()[0])

    t0 = clock()
    libs = build.build_all()
    ptxas = {n: [ln.strip() for ln in p.with_suffix(".log").read_text()
                 .splitlines() if "Used" in ln or "spill" in ln]
             for n, p in libs.items() if p.with_suffix(".log").exists()}
    emit("build", seconds=clock() - t0,
         libraries={n: str(p.relative_to(ROOT)) for n, p in libs.items()},
         ptxas=ptxas)

    t0 = clock()
    rows, details = {}, {}
    kernels = {"paged_attention": pa, "paged_extend_attention": pea,
               "flash_attention": fa, "quant_matmul": qm, "ssd_scan": ssd}
    checks = {"paged_attention": check_paged_attention,
              "paged_extend_attention": check_paged_extend_attention,
              "flash_attention": check_flash_attention,
              "quant_matmul": check_quant_matmul,
              "ssd_scan": lambda torch, k, r, t: check_ssd_scan(torch, k, r,
                                                                ssm, t)}
    for name, check in checks.items():
        rows[name], details[name] = check(torch, kernels[name], ref, cuda_ms)
    emit("kernels", seconds=clock() - t0,
         **{n: dict(rows[n], **details[n]) for n in rows})

    t0 = clock()
    emit("long_attention", **long_attention_phase(torch, kernels),
         seconds=clock() - t0)
    _release(torch)

    t0 = clock()
    eng, cfg, fields = serve_phase(torch, kernels, serve)
    launches = dict(fields["launches"])
    serve_fields = fields
    serve_tokens = {r.uid: list(r.generated) for r in eng.completed}
    emit("serve", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_phase(torch, M, eng, cfg)
    emit("model", seconds=clock() - t0, **fields)

    t0 = clock()
    eng8, fields = serve_int8_phase(torch, kernels, serve, eng, cfg)
    for name, n in fields["launches"].items():
        launches[name] += n
    del eng
    _release(torch)
    emit("serve_int8", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_int8_phase(torch, M, eng8, cfg)
    emit("model_int8", seconds=clock() - t0, **fields)
    params = eng8.params
    del eng8
    _release(torch)

    t0 = clock()
    fields = serve_dense_phase(torch, kernels, serve, params, cfg,
                               serve_tokens)
    _release(torch)
    emit("serve_dense", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_shared_phase(torch, kernels, serve, M, params, cfg)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_shared", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_spec_phase(torch, kernels, serve, M, params, cfg)
    for name, n in fields["launches"].items():
        launches[name] += n
    _release(torch)
    emit("serve_spec", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_traced_phase(torch, kernels, serve, params, cfg,
                                serve_fields, serve_tokens)
    # both drives' launches, each checked equal to serve's
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_traced", seconds=clock() - t0, **fields)

    t0 = clock()
    emit("split", **split_phase(torch, kernels, params, cfg),
         seconds=clock() - t0)

    t0 = clock()
    emit("early_exit", **early_exit_phase(torch, kernels, params, cfg),
         seconds=clock() - t0)

    t0 = clock()
    fields = long_prefill_phase(torch, kernels, serve, M, params, cfg)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("long_prefill", seconds=clock() - t0, **fields)
    _release(torch)

    t0 = clock()
    emit("launch_serve", **launch_serve_phase(torch, kernels, M, params, cfg),
         seconds=clock() - t0)
    del params
    _release(torch)

    t0 = clock()
    eng_ssm, cfg_ssm, fields = serve_ssm_phase(torch, kernels, serve, M)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_ssm", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_ssm_phase(torch, M, eng_ssm, cfg_ssm)
    del eng_ssm
    _release(torch)
    emit("model_ssm", seconds=clock() - t0, **fields)

    t0 = clock()
    cfg_tr, state, fields = train_phase(torch, kernels, train, M)
    train_busy_ms = fields["step_profile"].get("device_busy_ms",
                                               "not measured")
    emit("train", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_train_phase(torch, kernels, M, cfg_tr, state["params"])
    for name, n in fields["launches"].items():
        launches[name] += n
    _release(torch)
    emit("model_train", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = train_remat_phase(torch, kernels, M, cfg_tr, state)
    _release(torch)
    emit("train_remat", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = launch_phase(torch, kernels, train, M, cfg_tr, state,
                          train_busy_ms)
    del state
    _release(torch)
    emit("launch", seconds=clock() - t0, **fields)

    t0 = clock()
    _, fed_params, fields = federated_phase(torch, kernels, M)
    for name, n in fields["launches"].items():
        launches[name] += n
    _release(torch)
    emit("federated", seconds=clock() - t0, **fields)

    t0 = clock()
    eng_g, cfg_g, fields = serve_gemma_phase(torch, kernels, serve, M)
    for name, n in fields["launches"].items():
        launches[name] += n
    gemma_tokens = {r.uid: list(r.generated) for r in eng_g.completed}
    emit("serve_gemma", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_gemma_int8_phase(torch, kernels, serve, M, eng_g, cfg_g)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_gemma_int8", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_gemma_wide_phase(torch, kernels, M, eng_g, cfg_g)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_gemma_wide", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_async_phase(torch, kernels, serve, eng_g, cfg_g,
                               gemma_tokens)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_async", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = hub_phase(torch, kernels, serve, eng_g, cfg_g, gemma_tokens,
                       fed_params)
    for name, n in fields["launches"].items():
        launches[name] += n
    hub_days = fields["days"]
    del eng_g, fed_params
    _release(torch)
    emit("hub", seconds=clock() - t0, **fields)

    t0 = clock()
    eng_h, cfg_h, fields = serve_hybrid_phase(torch, kernels, serve, M)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_hybrid", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_hybrid_phase(torch, M, eng_h, cfg_h)
    del eng_h
    _release(torch)
    emit("model_hybrid", seconds=clock() - t0, **fields)

    t0 = clock()
    eng_m, cfg_m, fields = serve_moe_phase(torch, kernels, serve, M)
    for name, n in fields["launches"].items():
        launches[name] += n
    moe_tokens = {r.uid: list(r.generated) for r in eng_m.completed}
    emit("serve_moe", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_moe_int8_phase(torch, kernels, serve, M, eng_m, cfg_m,
                                  moe_tokens)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_moe_int8", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_moe_shared_phase(torch, kernels, serve, M, eng_m.params,
                                    cfg_m)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_moe_shared", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_moe_phase(torch, M, eng_m, cfg_m)
    del eng_m
    _release(torch)
    emit("model_moe", seconds=clock() - t0, **fields)

    t0 = clock()
    eng_v, cfg_v, fields = serve_vlm_phase(torch, kernels, serve, M)
    for name, n in fields["launches"].items():
        launches[name] += n
    vlm_tokens = {r.uid: list(r.generated) for r in eng_v.completed}
    emit("serve_vlm", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_phase(torch, M, eng_v, cfg_v)
    emit("model_vlm", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_vlm_int8_phase(torch, kernels, serve, M, eng_v, cfg_v,
                                  vlm_tokens)
    for name, n in fields["launches"].items():
        launches[name] += n
    params_v = eng_v.params
    del eng_v
    _release(torch)
    emit("serve_vlm_int8", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_vlm_shared_phase(torch, kernels, serve, M, params_v,
                                    cfg_v)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_vlm_shared", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = serve_vlm_spec_phase(torch, kernels, serve, M, params_v, cfg_v)
    for name, n in fields["launches"].items():
        launches[name] += n
    del params_v
    _release(torch)
    emit("serve_vlm_spec", seconds=clock() - t0, **fields)

    t0 = clock()
    eng_w, cfg_w, fields = serve_whisper_phase(torch, kernels, serve, M)
    for name, n in fields["launches"].items():
        launches[name] += n
    emit("serve_whisper", seconds=clock() - t0, **fields)

    t0 = clock()
    fields = model_phase(torch, M, eng_w, cfg_w)
    del eng_w
    _release(torch)
    emit("model_whisper", seconds=clock() - t0, **fields)

    for phase, arch in (("reference_vlm", VLM_ARCH),
                        ("reference_encdec", WHISPER_ARCH)):
        t0 = clock()
        emit(phase, **reference_extras(torch, M, get_smoke_config, kernels,
                                       arch), seconds=clock() - t0)

    t0 = clock()
    emit("reference_moe", **reference_moe(torch, M, get_smoke_config,
                                          kernels), seconds=clock() - t0)

    t0 = clock()
    emit("reference_gemma", **reference_gemma(
        torch, M, serve, get_smoke_config, kernels), seconds=clock() - t0)

    t0 = clock()
    fields = reference_phase(torch, M, serve, get_smoke_config, qm)
    fields.update(reference_ssm(torch, serve, get_smoke_config, kernels))
    fields.update(reference_hybrid(torch, serve, get_smoke_config, kernels))
    fields.update(reference_train(torch, M, get_smoke_config))
    emit("reference", seconds=clock() - t0, **fields)

    t0 = clock()
    emit("reference_shared", **reference_shared(
        torch, M, get_smoke_config, kernels), seconds=clock() - t0)

    t0 = clock()
    emit("reference_hub", **reference_hub(torch, M, get_smoke_config,
                                          hub_days), seconds=clock() - t0)

    close_mesh()
    t0 = clock()
    emit("dryrun", **dryrun_phase(), seconds=clock() - t0)

    emit("done", seconds=clock() - t_start)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name, row in rows.items():
        # main-path launches: the serve phases (the gemma int8 drive at
        # catch chunk 64, both serve_shared legs, the traced drive, both
        # serve_async legs and its CLI run included), model_train, the
        # federated round's held-out scoring and the hub's two
        # deployments, each counted from 0
        row["launches"] = launches[name]
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
