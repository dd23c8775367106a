#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (an H100 is assumed for
the bounds).

    python3 chip_smoke.py [--parent ROOT]

Phases, each fatal on failure:

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` (nvcc, sm_90a);
2. hold every kernel against its plain PyTorch version on the card, at
   the shapes of the serving and training paths, and time kernel, plain
   version and (where one exists) the one PyTorch call computing the same
   function.  The bthd flash kernels (#4, #6, #7) are checked on the
   encoder self-attention (key-padding bias [32, 1, 1, 256]), the decoder
   self-attention ([32, 1, 256, 256]), a cross case with target 128 and
   source 256, a ``causal=True`` case, a causal case with tq > tk and
   a row masked to -1e30, and three ragged cases (tq = tk = 200 under the
   decoder bias; causal tq 136 > tk 72 with a masked row; causal tq = tk
   = 129, one row past the forward's 128-row block), each kernel called
   twice for equal bits.  The bhtd flash kernels (#5, #8, #9) are
   checked at BERT-base's self-attention (q, k, v [128, 12, 128, 64],
   key-padding bias [128, 1, 1, 128] with -1e9 tails), with a per-head
   bias [128, 12, 128, 128] that requires grad (also through
   ``flash_attention(fmt="bhtd")``'s autograd: dq, dk, dv and dbias
   against autograd through the forward twin), ``causal=True``, causal
   with tq 128 > tk 64 and a row masked to -1e30, a cross case tq 64,
   tk 128, and three ragged cases (tq 72, tk 200; causal tq 200 > tk 136;
   tq 129, tk 72),
   each at rate 0 and 0.1 and each call repeated for equal bits, and
   timed beside masked ``F.scaled_dot_product_attention`` and its
   backward.  Each layout's two backward walks are also timed in one
   call sequence beside that backward (``flash_bwd``), and phase 1
   prints each walk instantiation's registers, spills and shared memory
   (``walk_builds``), and those of #19, ``gemm.cuh``'s GEMM and the flash
   forward (``tile_builds``).  The fused-projection training kernels (#1 with
   its residuals ctx and lse, #2 and #3) are checked at batch 32, 8 heads,
   d_model 512 on the encoder self-attention (t 256, bias [32, 1, 1,
   256]), the decoder self-attention (t 256, [32, 1, 256, 256]), a
   ``causal=True`` case and a ragged t = 200 with one row masked to -1e30
   (ctx 0, lse +inf, zero dx_q); #1 (in both modes), #2 and #3 are each
   called twice on the same inputs and must give equal bits.  So is the
   pair #2 + #3 (``qkv_bwd``: one ``ptt_qkv_bwd`` call with both walks,
   as the autograd backward makes it), held against its twin on the same
   cases and at BERT-base's self-attention (b 128, t 128, d_model 768),
   at rates 0 and 0.1; on a masked row its dx must equal #3's dx_kv bit
   for bit.  At BERT-base's case it is held against float64 (dW normwise)
   and elementwise against the f32 twin, and the f32 twin's own error
   against float64 is printed beside its.
   ``gemm.cuh``'s tile alone (``kernels.gemm``) is held against
   ``torch.matmul`` and timed beside it at the pair's three product
   shapes (GEMM_CASES) and at BERT-base's dW_qkv (M 768, N 2304, K 16384),
   where both products are also held against float64 and the depth of the
   slab it sums in one f32 sum is printed.  Each of
   #1-#4, #6 and #7 is checked again at weights-dropout rate 0.1 on every
   case against its twin (same seed, the same hash mask), and timed at
   rate 0.1 beside its rate-0 time.  #1 is checked on every route of its
   plan (``qkv_fwd_plan``: clusters of 1 to 8 blocks of 32 or 64 rows,
   and the tiles route at t > 512) on QKV_PLAN_CASES (t 8, BERT-base's
   self-attention, a ragged t 200, the b=1 prefill at t 256, the b=64
   decoder, t 512 and t 640; causal and not, each bias kind, rates 0 and
   0.1), each call repeated for equal bits, masked rows with ctx 0 and
   lse +inf, each timed with and without the host's enqueue, and the
   cluster occupancy of 8-block clusters printed (at head widths 64 and
   128);
   head widths by kernel and dtype (``check_head_width_128``): at 128 the
   serving path's f32 wrappers (#1 without a gradient, #14, #15, the
   fused ring and paged decoder steps) and the training wrappers in f32
   and bf16 (``flash_qkv_attention`` with a gradient, the pair,
   ``flash_attention`` in both layouts) each launch their head-width-128
   instantiations once, counted under ``*_dh128`` (the FFN under
   ``ffn``), and at 192 every wrapper and every (kernel, dtype) of the
   route table raises before any launch or composition.  The head-width-128 kernels themselves (C2
   part 1, ``check_head128_kernels``) are held at BIG's widths (8 heads
   of 128, d_model 1024): #1 at b=64 (clusters of 64 rows), b=1 (32
   rows) and t 640 (the tiles route), #10 and #12 at b=64, b=1, b=33 and
   full caches, the FFN after each at d_model 1024, #14 and #15 at b=64,
   b=1 and b=33 on both sides and full cross caches at b=64, each twice
   for equal bits, against its twin within TOL_KERNEL, timed beside its
   twin, its bound, the library call (#1, #14, #15) and its head-width-64
   instantiation on the same bytes (BIG64: 16 heads of 64, ``dh64_ms``);
   phase 1 requires the head-width-128 instantiations in the build and
   prints their registers and spills (``head128_builds``).
   The dropout-add kernels (#16, #17) are checked at [32*256, 512] f32:
   with x = 1 and residual 0, #16 must give the twin's keep pattern
   exactly, with a keep share within a chi-square bound of 0.9; #17 must
   equal its twin bit for bit.  The bf16 instantiations (amp) are held
   against their bf16 twins on the card at the amp step's shapes: #16
   (with and without a residual) and #17 at [32*256, 512] bit for bit,
   and so on the inputs that test their packed bf16x2 rounding
   (``dropout_bf16_cases``: every bf16 pattern of x, residuals that make
   ties at bf16's last bit and exponent gaps of 9-30, subnormals, +-0,
   +-inf, NaN and products that overflow, a numel of 8k + 5 and a view at
   an odd element; a NaN matches any NaN); each is timed with and without
   the host's enqueue beside the same-bytes ``torch.add`` /
   ``torch.mul`` (not the same function), also after a flush that leaves
   the L2's lines clean;
   #1 and the pair #2 + #3 (and #2, #3 alone) on QKV_CASES, #4, #6, #7 on
   AMP_FLASH_CASES (the cross-attention, the decoder bias, causal with a
   masked row, a ragged causal t 129), #5, #8, #9 on BHTD_BF16_CASES
   (BERT-base's self-attention with its padding bias, causal, causal tq >
   tk with a masked row, tq < tk, two ragged cases; each output also the
   bits of #4, #6, #7 on the transposed tensors), and #1 and the pair at
   BERT-base's self-attention (b 128, t 128, d_model 768: the shapes of
   (k)'s ``use_flash`` route), at rates 0 and 0.1, within one
   bf16 step (``compare_bf16``), each call repeated for equal bits, and
   timed beside masked ``F.scaled_dot_product_attention`` or
   ``F.multi_head_attention_forward`` in bf16; their bounds count 2
   bytes an element and the dense bf16 tensor-core rate (989 TFLOP/s).
   ``check_gemm`` also holds ``gemm.cuh``'s tensor-core tile at the amp
   step's six products (the pair's five and #1's y; an f32 operand as
   hi/lo bf16 planes) beside ``torch.matmul`` in bf16.  #4, #1 (with its
   y tile) and the pair #2 + #3 (its two walks and its five GEMMs) run
   on tensor cores in bf16: phase 1 requires HMMA/HGMMA instructions in
   each of their kernels' SASS (``sass_mma``, ``cuobjdump -sass``) and
   records their registers, spills and shared memory (``walk_builds``);
   their records carry their device-only times and the library call's,
   the pair's also its profile split between GEMM stages and walks
   beside ``torch.matmul`` on its five products.  At the record case at
   most TOL_OFF_ROUNDING of #4's o, #1's ctx and the pair's dx, dW_qkv
   and dW_out may differ from the float64 twin's value rounded to bf16
   (a kernel that rounded p to one bf16 would pass ``compare_bf16`` and
   fail this); the row masked in the forward gets dx_q = 0 from #2; and
   a bias copy at an odd element (not 4-byte aligned) must give the
   aligned bias's bits.  The bf16 ``gelu`` (the reference's bf16
   arithmetic, plain PyTorch) must give the CPU's bits on the card on
   all but GELU_CARD_SHARE of the finite bf16 inputs, ``F.gelu``'s
   differences from it counted.  With ``--parent ROOT``
   (another checkout, e.g. the parent commit unpacked by ``git
   archive``), its attention, GEMM and dropout kernels are built beside
   this tree's: phase 1 compares the registers of every f32
   instantiation, phase 2 times the parent's #4, #1 and the pair on the
   same inputs beside the redesigned ones (the pair's outputs' share off
   the rounded float64 value too) and holds every kernel this tree
   keeps to the parent's bits (``check_parent_bits``), and phase 4
   profiles the amp step on the parent's kernels too.  The conv +
   batch-norm kernels (#18-#21) are checked at ResNet-50's shapes
   at batch 256 (CBN_*_CASES: the stem, stage-1 and stage-4 sites, #19 at
   a strided shortcut, the stage-1 conv1 and a ragged M 1000, K 72, N 100
   too, #20/#21 with and without residual and ReLU; #18, #20 and #21 also
   at C = 2 and 6, whose channels they read one by one),
   each called twice for equal bits; their sums are held to TOL_SUM of
   the summed magnitudes against the same sums in float64.  The same
   cases in bf16 (``check_conv_bn_bf16``): #20's out and #21's dx and
   dres bit for bit against the bf16 twins, #19's y within one bf16 step
   of ``torch.matmul`` in bf16 (its share off the rounded float64 product
   recorded) and its sums against float64 sums over its own stored y, the
   other sums against float64 over the same bf16 values; shapes and mixes
   of types the kernels cannot take must raise before any launch
   (``check_conv_bn_refusals``); with
   ``--parent`` the f32 #18-#21 give the parent's bits.  cuDNN's output of the NHWC convolution must
   come back NHWC-contiguous.  The multi-table embedding kernels (#22,
   #23) are checked at DeepFM's shapes (26 tables of 1000001 rows, widths
   10 and 1, ids [26, 4096]): #22 on both groups, and with the ids mod
   10001, for the twin's bits; #23 in Adam mode on both groups and in SGD
   and scatter-add modes on the first, on three id mixes (planted runs of
   6 and 51 equal ids and a sentinel tail, the main path's uniform ids,
   zipf(1.1) draws), for the twin's bits and equal bits on a repeat, each
   timed beside a stable ``torch.sort`` of its ids.
   The decode megastep (#10 ring, #12 paged) is checked at b=1 and b=64
   and, on a generator of its own, at a ragged b=33 and at b=64 with every
   lane's self cache (128 rows) and cross cache (256 rows) full: each call
   twice on fresh copies of the caches for equal bits of the output and
   of the rows written in place, and against its twin within TOL_KERNEL,
   caches included; each record carries its plan (``megastep_plan``),
   the co-resident grid and its share of the bound.  The decode FFN (#11
   after the ring megastep, #13 after the paged one: one kernel) is
   checked on each megastep's plain output at b=1, b=64 and the ragged
   b=33: twice for equal bits and against ``reference_ffn`` within
   TOL_KERNEL; its records carry the plan (``ffn_plan``), the
   co-resident grid and the share of the bound;
3. the main paths on Transformer-base (6 layers, 8 heads, d_model 512,
   d_inner 2048, vocab 32000, source 256, 64 tokens) with seeded random
   weights.  The launch counters are zeroed just before each path and read
   just after it.
   (main) greedy generation on the ring cache, fused route, at batch 1 and
   64 through ``GenerationSession.prefill`` and 64 ``decode_step`` calls:
   6 qkv-attention launches per prefill, 6 megastep + 6 FFN launches per
   token.  The same model copied to the CPU (the plain path) is run
   teacher-forced on the card's token stream, and its cross cache and
   logits at every step must agree with the card's;
   (a) the unfused route on ring and on paged caches (static tables), at
   batch 1 and 64: 2 flash-decode launches per layer and token, no
   megastep or FFN launch; (b) the fused route on paged caches at batch
   64: 6 paged-megastep + 6 FFN launches per token.  Both are
   teacher-forced on the main path's tokens and their logits held against
   its logits on the card;
   (c) serving: ``GenerationServingModel`` + ``ContinuousBatcher`` with 64
   slots on the ring cache and on paged pools (256 blocks each side),
   160 requests from 16 client threads with staggered arrivals, 32 of them
   on 4 shared prompts; a request the batcher sheds (``Overloaded``) is
   resubmitted after its ``retry_after_s``, at most 3 times, and the shed
   and retry counts are printed.  Every request must get exactly its
   max_tokens tokens, the paged run must prefill once per prefix-registry
   leader, and the pools and the registry must drain; 16 sampled requests are
   replayed on a batch-1 session on the card, teacher-forced;
   (m) serving at head width 128 (``run_head128``) on BIG: Transformer-
   big's widths (d_model 1024, d_ff 4096, 6 + 6 layers, vocab 32000) with
   8 heads of 128, seeded weights, source 256, 64 tokens, at b=1 and 64:
   the ring fused route counted (6 ``qkv_attention_fwd_dh128`` a prefill,
   6 ``megastep_dh128`` and 6 ``ffn`` a token), at b=1 held against the
   CPU's plain path over all 64 tokens; the ring and paged unfused routes
   (12 ``flash_decode_dh128`` / ``flash_decode_paged_dh128`` a token)
   and the paged fused route (6 ``megastep_paged_dh128`` and 6 ``ffn``)
   teacher-forced on its tokens, logits within TOL_E2E; each timed; then
   the batcher on paged pools (64 slots, 48 requests); no composition;
   and one profiled prefill and 16 steps at each batch;
   (n) amp training at head width 128 (``run_head128_train``) on BIG's
   widths at ``bench_transformer``'s config (batch 32, source and target
   256, dropout 0.1, Adam at 1e-4, ``amp.enable``), on the default route
   (12 each of ``qkv_attention_fwd_bf16_dh128``, ``qkv_bwd_dq_bf16_dh128``,
   ``qkv_bwd_dkv_bf16_dh128`` and 6 each of ``flash_fwd_bf16_dh128``,
   ``flash_bwd_dq_bf16_dh128``, ``flash_bwd_dkv_bf16_dh128`` a step) and
   the flag-off route (18 each of the flash ones), 30 + 2 of #16/#17, no
   composition: step 1 at batch 2, length 64 (HEAD128_TRAIN_PARITY) under
   fixed seeds, repeated for equal bits, against a float64 CPU step of
   the plain path (TOL_AMP_LOSS, TOL_AMP_GRAD), the routes' losses within
   TOL_AMP_ROUTES_LOSS; then 8 timed steps through an ``amp.LossScaler``
   on one repeated full batch whose loss must fall, with no overflow; one
   profiled step a route (device busy, idle share).  Phase 2 holds the
   bf16 kernels of this path at head width 128 (#1 on clusters of 64 and
   32 rows and the tiles route, the pair and each walk, #4-#9 in both
   layouts, with the bthd kernels' bits from the bhtd ones) against their
   twins at BIG's widths, beside the same cases at 16 heads of 64
   (``check_head128_train_kernels(torch.bfloat16, ...)``), and
   ``check_head_width_128`` the route table: every kernel at 192 raises
   before any launch;
   (o) f32 training at head width 128 (``run_head128_train``): (n)'s model,
   configuration and routes in f32 with TF32 off (12 each of
   ``qkv_attention_fwd_dh128``, ``qkv_bwd_dq_dh128``,
   ``qkv_bwd_dkv_dh128`` and 6 each of ``flash_fwd_dh128``,
   ``flash_bwd_dq_dh128``, ``flash_bwd_dkv_dh128`` a fused step; 18 each
   of the flash ones a flag-off step; 32 each of #16/#17), every step's
   launches checked, no composition: step 1 at batch 2, length 64 (cut as
   (n)'s) under fixed seeds, repeated for equal bits, against a float64
   CPU step of the plain path (TOL_TRAIN_LOSS; each gradient within
   TOL_TRAIN_GRAD or twice an f32 CPU copy's error), the routes' losses
   within TOL_ROUTES_LOSS; then 8 timed Adam steps on one repeated full
   batch whose loss must fall; one profiled step a route.  Phase 2 holds
   the f32 kernels of this path at 128 (``check_head128_train_kernels(
   torch.float32, ...)``: the same cases as in bf16, within TOL_KERNEL of
   the f32 twins, the record cases also against the twins in float64);
   every phase-3 record goes to a file of its own in OUT_DIR
   (``keep_phase3``) and a short summary of each is printed before the
   kernels line;
   (d) training: ``Transformer(fused_qkv_attention=False)`` with Paddle's
   ``Adam(1e-4)`` at batch 32, source and target 256 with seeded padded
   tails (label weight 0 on the pads): 18 ``flash_fwd``, 18
   ``flash_bwd_dq`` and 18 ``flash_bwd_dkv`` launches per step and no
   ``qkv_attention_fwd``.  The same model copied to the CPU takes the same
   first 2 steps through the plain path, at the full batch (about a
   minute): each step's loss within 1e-4 relative.  A float64 copy on the
   CPU gives step 1's exact gradient; the card's must be within 1e-4
   relative of it per parameter tensor (norm), or no further than twice
   the CPU's f32 gradient is (f32 alone is off by more than 1e-4 at this
   depth and length; see TOL_TRAIN_GRAD).  Then 10 timed steps on the card
   on one repeated batch (median step ms, target tokens/s, share of the
   f32 peak), whose loss must fall;
   (e) training on the default route (``fused_qkv_attention=True``) from
   (d)'s initial weights and on (d)'s batch: 12 ``qkv_attention_fwd``, 12
   ``qkv_bwd_dq`` and 12 ``qkv_bwd_dkv`` launches per step (the self-
   attention sites) and 6 each of the bthd kernels (the cross sites).
   Step 1, run twice, must give equal gradient bits; its loss and
   gradients are held against (d)'s float64 evaluation under (d)'s
   criterion, step 2's loss against (d)'s CPU f32 step 2; then 10 timed
   steps as in (d), printed beside (d)'s;
   (f) dropout training: the default route at ``dropout_rate=0.1`` from
   (d)'s initial weights on (d)'s batch: per step 32 ``dropout_add_fwd``
   and 32 ``dropout_add_bwd`` launches (30 residual sites and 2 embedding
   sites), 12 each of #1-#3 and 6 each of #4, #6, #7.  Step 1 runs under
   fixed seeds, twice, for equal gradient bits; float64 and f32 CPU
   copies take the same step under the same seeds, and the card is held
   to (d)'s criterion against them.  The
   flag-off route on the card under the same seeds must give step 1's
   loss within 1e-5 relative (the same masks).  Then 10 timed steps, each
   with fresh seeds, whose loss must fall, printed beside (e)'s rate-0
   step of the same run;
   (g) ResNet-50 training as the reference's ``bench_resnet50`` (224,
   1000 classes, NHWC, Momentum 0.1 / 0.9, f32 where the bench runs bf16)
   from ``init_params(0)``: 17 ``channel_stats``, 36 ``dot_col_stats``,
   53 ``ssa_fwd`` and 53 ``ssa_bwd`` launches per step.  Step 1 at batch
   16 against float64 and f32 CPU copies under (d)'s criterion
   (gradients, running statistics, updated parameters); step 1 at batch
   256 run twice for equal bits (``cudnn.deterministic``) and held against
   the card's plain route (the twins of #18-#21 on the card); then 10
   timed steps at batch 256 on one repeated batch (median step ms,
   images/s, f32 peak share, peak memory), whose first update must lower
   the loss.  The NCHW route (``data_format="NCHW"``: the reference's
   unfused conv2d + batch_norm composition, no kernel) takes step 1 at
   batch 16 from the same state, held to float64 under the same
   criterion;
   (h) DeepFM training as the reference's ``bench_deepfm`` (batch 4096,
   26 slots, hash_dim 1000001, embedding 10, lazy Adam 1e-3,
   FLAGS_fused_embedding on) from ``init_params(0)``: 2 ``multi_table_
   gather`` and 2 ``multi_table_apply`` launches per step; step 1 twice
   for equal bits; 3 steps against the per-table composition on the card
   (losses, tables and moments within rtol 2e-4, atol 2e-5, and each
   tensor within 2e-4 of its largest magnitude); 10 timed
   steps after a warm-up, cycling 8 ``make_batch`` batches (median step
   ms, examples/s, the analytic sparse-bytes share), whose loss must
   fall; one step at hash_dim 10001 against float64 under (d)'s
   criterion.  Then the reference demo's widths (head width 16), served
   through the batcher on the card: no attention or decode kernel
   launches, the composition counter counts, and the CPU plain path's
   tokens;
   (i) BERT-base pretraining as the reference's ``bench_bert`` (12
   layers, 12 heads of 64, d_model 768, d_ff 3072, vocab 30522, seq 128,
   batch 128, dropout 0.1, Adam 1e-4; f32 where the bench runs amp) from
   ``init_params(0)`` on ``make_batch`` batches with padded tails: the
   reference's default build after ``attention_fuse`` (every site
   ``fused_attention(fmt="bhtd")``) launches 12 each of #5, #8, #9 and 25
   each of #16, #17 (24 residual sites and the embedding's) per step and
   nothing else.  Step 1 under fixed per-site seeds runs twice for equal
   gradient bits; at batch 4 it is held against float64 and f32 CPU
   copies under the same seeds by (d)'s criterion.  The ``use_flash=True``
   route (12 each of #1-#3) gives step 1's loss within 1e-5 under the
   same seeds (the same masks), and the unfused composition (no pass, no
   kernel) the fused route's rate-0 loss within 1e-5.  Then 10 timed
   steps with fresh seeds on each kernel route (median step ms, tokens/s,
   f32 peak share by ``bench.py``'s ``bert_train_flops_per_token``, peak
   memory), whose loss must fall.  (i) keeps the float64 step for (k);
   (j) bf16 amp training as ``bench_transformer`` runs it by default
   (``amp.enable``: the reference's cast policy; the default route at
   dropout 0.1, batch 32, length 256, Adam 1e-4) from (d)'s initial
   weights: per step 12 each of #1-#3 and 6 each of #4, #6, #7 in bf16,
   30 each of #16 and #17 in bf16 (the residual sites) and 2 each in f32
   (the embedding sites), no f32 attention launch.  Step 1 under (f)'s
   seeds runs twice for equal gradient bits, every gradient f32, and is
   held against (f)'s float64 step (TOL_AMP_LOSS, TOL_AMP_GRAD); then 10
   timed steps with fresh seeds (median step ms, target tokens/s, the
   bf16 peak share, peak memory) beside (f)'s f32 step;
   (k) BERT-base pretraining under bf16 amp as ``bench_bert`` runs it
   (``amp.enable`` on (i)'s two kernel-route models, reloaded with their
   initial weights, fresh Adam state): the bhtd route (``attention_fuse``)
   launches 12 each of #5, #8, #9 in bf16 per step, the ``use_flash``
   route 12 each of #1-#3 in bf16, both 24 each of #16 and #17 in bf16
   (the residual sites) and 1 each in f32 (the embedding's), and no f32
   attention kernel.  Each route's step 1 under (i)'s seeds: at batch 4
   held against (i)'s float64 step (TOL_AMP_LOSS, TOL_AMP_GRAD, every
   gradient f32, the encoder output bf16), at batch 128 twice for equal
   gradient bits; the two routes' losses within TOL_AMP_ROUTES_LOSS; then
   10 timed steps with fresh seeds (median step ms, tokens/s, the bf16
   peak share, peak memory) beside (i)'s f32 numbers, whose loss must
   fall;
   (l) ResNet-50 training under bf16 amp as ``bench_resnet50`` runs it
   (``amp.enable``, (g)'s initial weights, fresh Momentum state): 17
   ``channel_stats_bf16``, 36 ``dot_col_stats_bf16``, 53 ``ssa_fwd_bf16``
   and 53 ``ssa_bwd_bf16`` launches per step and no f32 conv + BN launch.
   Step 1 at batch 16 against (g)'s float64 step (TOL_RESNET_AMP_*: the
   loss, the running statistics, each gradient's and update's norm and
   their median, their median cosine, the head's distance; the
   stem's output and the pooled features bf16, predict, the loss and every
   gradient f32); step 1 at batch 256 twice for equal bits and against
   the card's plain route (TOL_RESNET_AMP_ROUTES_*); then 10 timed steps
   (median step ms, images/s, the bf16 peak share, peak memory) beside
   (g)'s f32 numbers, whose first update must lower the loss;
4. where the time goes: torch.profiler over one prefill and 16 decode
   steps at each batch on the ring cache and at b=64 on paged pools (the
   megastep's and the FFN's device ms a step beside the idle share), and
   over one training step on each route, on the dropout route, under
   amp (j) (its device time split by the launching op and by elementwise
   kernel, #16/#17's share beside), of
   ResNet-50, of DeepFM (with #22's and #23's device ms a step) and of
   BERT-base on both kernel routes in f32 and under amp (k) (the amp
   steps' device time split by phase, launching op and elementwise
   kernel, and #5's, #8's and #9's device ms a step): device time by
   kernel beside host wall time, and for
   ResNet-50 in f32 and under amp (l) any layout-conversion kernel,
   cuDNN's, cuBLAS's and the elementwise kernels' ms, each conv + BN
   kernel's ms a step and #19's beside the summed bound of its 36 sites
   (under amp each of #18-#21's beside its summed bf16 bound).
   Every phase prints its seconds.

Prints the card and its power limit, the timings, one JSON line with a
record per kernel, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without a CUDA card or without the package
beside it.  f32 with TF32 off for matmuls and cuDNN, but for the bf16
checks of phase 2 and the amp steps (j), (k) and (l).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

#: kernel-vs-plain tolerance (abs and rel), f32 with TF32 off: the kernels
#: sum in other orders than cuBLAS
TOL_KERNEL = 2e-4
#: end-to-end logits tolerance (abs and rel): 12 layers deep, card against
#: the CPU's plain path, 64 steps of cache built by each side
TOL_E2E = 2e-4

BASE = dict(src_vocab_size=32000, trg_vocab_size=32000, max_length=258,
            n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
            d_inner_hid=2048)
SRC_LEN, MAX_OUT = 256, 64
BATCHES = (1, 64)
BLOCK_T = 16

#: H100 SXM data-sheet peaks used for the bounds: HBM bytes/s and dense
#: f32 FLOP/s outside the tensor cores (the kernels run f32 FMAs)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: int32 operations/s outside the tensor cores: half the f32 FMA lanes
#: (64 of 128 per SM and clock on compute capability 9.0), one operation
#: each, on 132 SMs at 1.98 GHz
PEAK_INT32_OPS = 16.7e12
#: thread-instruction slots per second (4 schedulers of 32 lanes per SM
#: and clock, as many as the f32 FMA lanes): an f32 FMA (2 FLOPs) and an
#: int32 operation take one slot each, the int32 units beside the f32 ones
PEAK_SLOTS = 2 * PEAK_INT32_OPS
F32 = 4
#: the training dropout rate (the reference's ``transformer()`` default)
DROPOUT = 0.1
#: integer operations of one keep bit: the dropout-add hash (index times
#: GOLDEN plus seed, lowbias32's 3 xor-shifts and 2 multiplies, compare)
#: and the attention one (the plane index q * tk + k, times GOLDEN plus the
#: head seed, mix32_fast's 2 xor-shifts and 1 multiply, compare)
HASH_OPS, ATTN_HASH_OPS = 11, 9

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters=20, warmup=3, hide_host=False, clean=False):
    """Median device time of one fn() call, each timed alone with CUDA
    events after writing a 256 MB buffer: the main path finds the L2 cold
    (its 6 layers' weights, 88 MB in the decode step, exceed the 50 MB
    L2), so a kernel timed back to back on the same warm inputs would
    read too fast.  The write leaves the L2 full of dirty lines, which fn
    writes back as it allocates its own; ``clean`` reads the buffer
    instead, so that the L2 holds clean lines.  The events also count any
    wait of the device for the host to enqueue fn's launches;
    ``hide_host`` puts a 1 ms device-side spin before the start event, so
    that the host has enqueued all of fn (a sync-free fn) before the
    device reaches it and only device time is counted."""
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        if hide_host:
            torch.cuda._sleep(2_000_000)   # ~1 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(flops, nbytes, int_ops=0):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and the
    operations: the larger of their slot time (f32 FLOPs at the f32 peak
    plus int32 operations at PEAK_SLOTS) and the int32 units' own time
    (at PEAK_INT32_OPS)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOPS + int_ops / PEAK_SLOTS,
                int_ops / PEAK_INT32_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, want, tol):
    """Max abs error; raises unless |got - want| <= tol + tol*|want|."""
    got, want = got.float(), want.float()
    require(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    err = (got - want).abs()
    worst = (err - tol * want.abs()).max().item()
    max_abs = err.max().item()
    require(worst <= tol, f"{name}: max abs err {max_abs} over tol {tol}")
    return max_abs


def randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).cuda()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_qkv_attention(gen, b, cfg=BASE, t=SRC_LEN):
    """#1 at the prefill's shapes of ``cfg`` (serving: no gradient), twice
    for equal bits, against its twin and ``F.multi_head_attention_forward``,
    timed beside both; the record carries the plan."""
    import torch.nn.functional as F

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import attention as ka

    dm, h, dh = cfg["d_model"], cfg["n_head"], cfg["d_key"]
    hd = h * dh
    name = "qkv_attention_fwd" + kernels.width_suffix(dh)
    x = randn(gen, b, t, dm)
    w_qkv = randn(gen, dm, 3 * hd, scale=dm ** -0.5)
    w_out = randn(gen, hd, dm, scale=hd ** -0.5)
    # padded tails of ragged lengths (row 0 unpadded), as the prefill's
    # key-padding bias
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen)
    lens[0] = t if b > 1 else t - 56
    pad = torch.arange(t)[None, :] >= lens[:, None]
    bias = (-1e9 * pad.float()).reshape(b, 1, 1, t).cuda()
    kw = dict(n_head=h, scale=dh ** -0.5)
    got = ka.flash_qkv_attention(x, w_qkv, w_out, bias, **kw)
    again = ka.flash_qkv_attention(x, w_qkv, w_out, bias, **kw)
    want = ka.reference_qkv_attention(x, w_qkv, w_out, bias, **kw)
    torch.cuda.synchronize()
    require(torch.equal(got, again),
            f"{name} b={b} t={t}: two calls on the same inputs differ")
    err = compare(f"{name} b={b} t={t}", got, want, TOL_KERNEL)

    # one PyTorch call computing the same function (a yardstick only)
    xt = x.transpose(0, 1)
    mask = bias.reshape(b, t)

    def library():
        return F.multi_head_attention_forward(
            xt, xt, xt, dm, h, w_qkv.t(), None, None, None, False, 0.0,
            w_out.t(), None, training=False, key_padding_mask=mask,
            need_weights=False)[0]

    lib_err = (library().transpose(0, 1) - want).abs().max().item()
    flops = b * (2 * t * dm * 3 * hd + 4 * t * t * hd + 2 * t * hd * dm)
    nbytes = F32 * (2 * b * t * dm + dm * 3 * hd + hd * dm + b * t)
    rec = timed_record(
        name, "paddle_tpu_torch/csrc/qkv_attention.cu",
        "paddle_tpu/kernels/attention.py:1377", err,
        lambda: ka.flash_qkv_attention(x, w_qkv, w_out, bias, **kw),
        lambda: ka.reference_qkv_attention(x, w_qkv, w_out, bias, **kw),
        flops, nbytes, library, b)
    rec["library_max_abs_err"] = lib_err
    rec["plan"] = list(ka.qkv_fwd_plan(b, t, h, ka.sm_count(x.device)))
    rec["t"] = t
    return rec


def _decode_weights(gen, cfg=BASE):
    dm, h, dh = cfg["d_model"], cfg["n_head"], cfg["d_key"]
    di = cfg["d_inner_hid"]
    hd = h * dh
    w = dict(
        wqkv=randn(gen, dm, 3 * hd, scale=dm ** -0.5),
        wout=randn(gen, hd, dm, scale=hd ** -0.5),
        ln1_scale=1 + randn(gen, dm, scale=0.1), ln1_bias=randn(gen, dm,
                                                                 scale=0.1),
        wcq=randn(gen, dm, hd, scale=dm ** -0.5),
        wcout=randn(gen, hd, dm, scale=hd ** -0.5),
        ln2_scale=1 + randn(gen, dm, scale=0.1), ln2_bias=randn(gen, dm,
                                                                 scale=0.1))
    ffn = dict(
        ffn_in_w=randn(gen, dm, di, scale=dm ** -0.5),
        ffn_in_b=randn(gen, di, scale=0.1),
        ffn_out_w=randn(gen, di, dm, scale=di ** -0.5),
        ffn_out_b=randn(gen, dm, scale=0.1),
        ln3_scale=1 + randn(gen, dm, scale=0.1), ln3_bias=randn(gen, dm,
                                                                 scale=0.1))
    return w, ffn


def _decode_inputs(gen, b, full=False, cfg=BASE):
    """The ring megastep's inputs at ``cfg``'s widths (Transformer-base's
    by default): self caches of 128 rows and cross caches of SRC_LEN.
    Ragged positions mid-generation, the last lane inactive and lane 0 of
    a batch > 1 with an empty cross cache; ``full``: every lane active at
    row 127 and every cross cache full."""
    h, dh, L = cfg["n_head"], cfg["d_key"], cfg["n_layer"]
    w, ffn = _decode_weights(gen, cfg)
    self_rows, cross_rows = 128, SRC_LEN
    caches = dict(
        cache_k=randn(gen, L, b, self_rows, h, dh),
        cache_v=randn(gen, L, b, self_rows, h, dh),
        cross_k=randn(gen, L, b, cross_rows, h, dh),
        cross_v=randn(gen, L, b, cross_rows, h, dh))
    pos = torch.randint(0, MAX_OUT, (b,), generator=gen)
    active = torch.ones(b, dtype=torch.int64)
    cross_len = torch.randint(1, cross_rows + 1, (b,), generator=gen)
    if full:
        pos[:], cross_len[:] = self_rows - 1, cross_rows
    elif b > 1:
        active[-1] = 0
        cross_len[0] = 0
    ints = dict(pos=pos, lengths=pos + active, cross_lengths=cross_len,
                active=active)
    ints = {k: v.to(torch.int32).cuda() for k, v in ints.items()}
    x = randn(gen, b, 1, cfg["d_model"])
    return x, w, ffn, caches, ints


def _megastep_bytes_flops(b, ints, extra_bytes=0, cfg=BASE):
    """(bytes, flops) of one megastep call: the weights once, x and out,
    the k/v row written, the rows the walks read (their valid rows), the
    int32 vectors; 2 FLOPs a weight a row and 4 a head dim a row walked."""
    dm, hd = cfg["d_model"], cfg["n_head"] * cfg["d_key"]
    act = ints["active"].long()
    self_rows = ints["lengths"].long().clamp(min=0).sum().item()
    cross_rows = ints["cross_lengths"].long().clamp(min=0).sum().item()
    n_act = act.sum().item()
    self_rows -= n_act  # the fresh rows are written, not read
    weights = 6 * dm * hd + 4 * dm
    nbytes = (F32 * (weights + 2 * b * dm
                     + 2 * hd * (self_rows + cross_rows + n_act))
              + 16 * b + extra_bytes)
    flops = 2 * b * weights + 4 * hd * (self_rows + n_act + cross_rows)
    return nbytes, flops


def _held_megastep(what, call, plain, caches, b):
    """Call the kernel twice on two fresh copies of ``caches`` (equal bits
    of out and of both self caches, the rows written in place included)
    and its twin on a third; hold out and the caches to TOL_KERNEL.
    Returns (max abs err, the twin's out, the kernel's copy, the twin's)."""
    copies = [{k: v.clone() for k, v in caches.items()} for _ in range(3)]
    got = call(copies[0])
    again = call(copies[1])
    want = plain(copies[2])
    torch.cuda.synchronize()
    require(torch.equal(got, again)
            and all(torch.equal(copies[0][n], copies[1][n])
                    for n in ("cache_k", "cache_v")),
            f"{what}: two calls on the same inputs differ")
    err = compare(what, got, want, TOL_KERNEL)
    for name in ("cache_k", "cache_v"):
        err = max(err, compare(f"{what} {name}", copies[0][name],
                               copies[2][name], TOL_KERNEL))
    return err, want, copies[0], copies[2]


def _plan_fields(x, paged, self_rows, cross_rows, cfg=BASE):
    """The megastep's plan on this card and its co-resident grid."""
    from paddle_tpu_torch.kernels import decode_step as kds
    from paddle_tpu_torch.kernels.attention import sm_count

    plan = kds.device_megastep_plan(x.device, paged, x.shape[0],
                                    cfg["n_head"], cfg["d_model"],
                                    self_rows, cross_rows, cfg["d_key"])
    return dict(plan=plan._asdict(), co_resident_grid=plan.grid,
                blocks_per_sm=plan.grid // sm_count(x.device))


def check_megastep(x, w, caches, ints, b, label="", cfg=BASE):
    """#10 at these inputs: twice for equal bits, against its twin, timed
    beside it; the record carries the plan."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import decode_step as kds

    h, dh = cfg["n_head"], cfg["d_key"]
    name = "megastep" + kernels.width_suffix(dh)
    kw = dict(layer=cfg["n_layer"] // 2, n_head=h, scale=dh ** -0.5)
    err, want, mine, plain = _held_megastep(
        f"{name}{label} b={b}",
        lambda c: kds.megastep(x, **w, **c, **ints, **kw),
        lambda c: kds.reference_megastep(x, **w, **c, **ints, **kw),
        caches, b)
    nbytes, flops = _megastep_bytes_flops(b, ints, cfg=cfg)
    rec = timed_record(
        name, "paddle_tpu_torch/csrc/megastep.cu",
        "paddle_tpu/kernels/decode_step.py:229", err,
        lambda: kds.megastep(x, **w, **mine, **ints, **kw),
        lambda: kds.reference_megastep(x, **w, **plain, **ints, **kw),
        flops, nbytes, None, b)
    rec.update(_plan_fields(x, False, caches["cache_k"].shape[2],
                            caches["cross_k"].shape[2], cfg))
    return rec, want


def check_decode_kernels(gen, b, cfg=BASE):
    x, w, ffn, caches, ints = _decode_inputs(gen, b, cfg=cfg)
    mega, want = check_megastep(x, w, caches, ints, b, cfg=cfg)
    return mega, check_ffn(want, ffn, b, "ffn", FFN_REPLACES["ffn"],
                           cfg=cfg)


def check_ffn(x, ffn, b, name, replaces, label="", cfg=BASE):
    """#11 (and #13, the same kernel after the paged megastep) on the
    megastep's plain output x: twice for equal bits, against its twin,
    timed beside it; the record carries the plan (``ffn_plan``) and the
    co-resident grid."""
    from paddle_tpu_torch.kernels import decode_step as kds
    from paddle_tpu_torch.kernels.attention import sm_count

    dm, di = cfg["d_model"], cfg["d_inner_hid"]
    got = kds.ffn_epilogue(x, **ffn)
    again = kds.ffn_epilogue(x, **ffn)
    want = kds.reference_ffn(x, **ffn)
    torch.cuda.synchronize()
    require(torch.equal(got, again),
            f"{name}{label} b={b}: two calls on the same inputs differ")
    err = compare(f"{name}{label} b={b}", got, want, TOL_KERNEL)
    rec = timed_record(
        name, "paddle_tpu_torch/csrc/ffn.cu", replaces, err,
        lambda: kds.ffn_epilogue(x, **ffn),
        lambda: kds.reference_ffn(x, **ffn), 4 * b * dm * di,
        F32 * (2 * dm * di + di + 3 * dm + 2 * b * dm), None, b)
    plan = kds.device_ffn_plan(x.device, b, dm, di)
    rec.update(plan=plan._asdict(), co_resident_grid=plan.grid,
               blocks_per_sm=plan.grid // sm_count(x.device))
    return rec


def timed_record(name, source, replaces, err, fn, plain, flops, nbytes,
                 library, b, int_ops=0, bound_fn=None):
    """A kernel record: fn and plain timed alone after an L2 flush, the
    bound from flops, int_ops and nbytes (by ``bound_fn``, default
    :func:`bound`), library timed where there is one."""
    bound_ms, bound_by = (bound_fn or bound)(flops, nbytes, int_ops)
    ms = cuda_ms(fn)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=cuda_ms(plain),
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms,
                library_ms=cuda_ms(library) if library else None, batch=b)


def flash_bwd_record(replaces, err, fn, plain, flops, nbytes, library, b):
    """A layout's two backward walks as the autograd backward calls them:
    dq, then dk and dv, in one timed call sequence beside the library's
    backward (dq, dk, dv) in the same run.  ``flops`` is b * h * 64 per
    visible (q, k) pair, the MACs of one t x t product: the bound counts
    the function's least work, five such products (s, dp, dq, dk, dv);
    the two walks compute seven (s and dp in both), ``walks_bound_ms``."""
    r = timed_record("flash_bwd", "paddle_tpu_torch/csrc/flash_walk.cuh",
                     replaces, err, fn, plain, 10 * flops, nbytes, library,
                     b)
    r.update(walks_bound_ms=bound(14 * flops, nbytes)[0],
             library_factor=r["ms"] / r["library_ms"])
    return r


def _spread_lengths(gen, b, lo, hi):
    """[b] int32 lengths uniform in [lo, hi]; lane 0 of a batch > 1 is
    empty."""
    lens = torch.randint(lo, hi + 1, (b,), generator=gen)
    if b > 1:
        lens[0] = 0
    return lens.to(torch.int32).cuda()


def _shuffled_table(gen, b, max_blocks, holes=8):
    """A [b, max_blocks] int32 table over a pool of b*max_blocks + holes
    blocks, every id used at most once, in shuffled order."""
    n = b * max_blocks + holes
    perm = torch.randperm(n, generator=gen)[:b * max_blocks]
    return perm.reshape(b, max_blocks).to(torch.int32).cuda(), n


def _library_decode(q, k, v, lens, scale):
    """One PyTorch call for single-query attention over a length-masked
    [b, t, h, dh] cache (a yardstick only)."""
    import torch.nn.functional as F

    t = k.shape[1]
    mask = (torch.arange(t, device=q.device)[None, :]
            < lens.long()[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, scale=scale)[:, :, 0, :]


def _decode_plan_fields(q, paged, rows):
    """Flash-decode's plan on this card (``decode_plan``) and its grid."""
    from paddle_tpu_torch.kernels import decode_attention as kda
    from paddle_tpu_torch.kernels.attention import sm_count

    plan = kda.device_decode_plan(q.device, paged, q.shape[0], q.shape[1],
                                  rows, q.shape[2])
    return dict(plan=plan._asdict(), co_resident_grid=plan.grid,
                blocks_per_sm=-(-plan.grid // sm_count(q.device)))


def _flash_decode_inputs(gen, b, side, full=False, cfg=BASE):
    """One side's flash-decode draws: the self side (128 rows, lengths
    1-128) or the cross side (SRC_LEN rows, lengths 8-256), lane 0 empty
    (``full``: every lane at its capacity), and the same rows scattered
    over pools of BLOCK_T-row blocks through a shuffled table with holes.
    Returns (q, k, v, lengths, table, k_pool, v_pool)."""
    h, dh, bt = cfg["n_head"], cfg["d_key"], BLOCK_T
    rows, lo = (128, 1) if side == "self" else (SRC_LEN, 8)
    q = randn(gen, b, h, dh)
    k, v = randn(gen, b, rows, h, dh), randn(gen, b, rows, h, dh)
    lens = _spread_lengths(gen, b, lo, rows)
    if full:
        lens.fill_(rows)
    mb = rows // bt
    table, nb = _shuffled_table(gen, b, mb)
    k_pool = torch.empty((nb, bt, h, dh), device=k.device)
    v_pool = torch.empty_like(k_pool)
    k_pool[table.long()] = k.reshape(b, mb, bt, h, dh)
    v_pool[table.long()] = v.reshape(b, mb, bt, h, dh)
    return q, k, v, lens, table, k_pool, v_pool


def _held_flash_decode(gen, b, side, full=False, cfg=BASE):
    """#14 and #15 on one side's draws (:func:`_flash_decode_inputs`), the
    paged walk over the same rows as the ring's.  Each kernel is called
    twice for equal bits and held against its twin, the paged one against
    the ring's twin too, and timed with the host's enqueue (``ms``) and
    without it (``device_ms``).  Returns (ring record, paged record)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import decode_attention as kda

    h, dh = cfg["n_head"], cfg["d_key"]
    sfx = kernels.width_suffix(dh)
    label = f"{side} b={b}{' full' if full else ''}"
    scale = dh ** -0.5
    q, k, v, lens, table, k_pool, v_pool = _flash_decode_inputs(
        gen, b, side, full, cfg)
    rows, mb = k.shape[1], table.shape[1]
    n_rows = lens.long().sum().item()
    flops = 4 * h * dh * n_rows
    io = F32 * (2 * b * h * dh + 2 * h * dh * n_rows) + 4 * b
    got = kda.flash_decode(q, k, v, lens, scale)
    again = kda.flash_decode(q, k, v, lens, scale)
    want = kda.reference_decode(q, k, v, lens, scale)
    torch.cuda.synchronize()
    require(torch.equal(got, again),
            f"flash_decode{sfx} {label}: two calls on the same inputs "
            f"differ")
    err = compare(f"flash_decode{sfx} {label}", got, want, TOL_KERNEL)
    live = lens > 0
    lib_err = (_library_decode(q, k, v, lens, scale)[live]
               - want[live]).abs().max().item()
    ring = timed_record(
        "flash_decode" + sfx, "paddle_tpu_torch/csrc/decode_attention.cu",
        "paddle_tpu/kernels/decode_attention.py:61", err,
        lambda: kda.flash_decode(q, k, v, lens, scale),
        lambda: kda.reference_decode(q, k, v, lens, scale), flops, io,
        lambda: _library_decode(q, k, v, lens, scale), b)
    ring["library_max_abs_err"] = lib_err
    ring["device_ms"] = cuda_ms(lambda: kda.flash_decode(q, k, v, lens,
                                                         scale),
                                hide_host=True)
    ring.update(_decode_plan_fields(q, False, rows))
    ring["side"] = side

    # the same rows scattered over a pool through a shuffled table
    got = kda.flash_decode_paged(q, k_pool, v_pool, table, lens, scale)
    again = kda.flash_decode_paged(q, k_pool, v_pool, table, lens, scale)
    want_p = kda.reference_decode_paged(q, k_pool, v_pool, table, lens,
                                        scale)
    torch.cuda.synchronize()
    require(torch.equal(got, again),
            f"flash_decode_paged{sfx} {label}: two calls on the same inputs "
            f"differ")
    err = max(compare(f"flash_decode_paged{sfx} {label}", got, want_p,
                      TOL_KERNEL),
              compare(f"flash_decode_paged{sfx} {label} vs ring", got, want,
                      TOL_KERNEL))

    def library():
        gk = k_pool[table.long()].reshape(b, rows, h, dh)
        gv = v_pool[table.long()].reshape(b, rows, h, dh)
        return _library_decode(q, gk, gv, lens, scale)

    paged = timed_record(
        "flash_decode_paged" + sfx,
        "paddle_tpu_torch/csrc/decode_attention.cu",
        "paddle_tpu/kernels/decode_attention.py:282", err,
        lambda: kda.flash_decode_paged(q, k_pool, v_pool, table, lens,
                                       scale),
        lambda: kda.reference_decode_paged(q, k_pool, v_pool, table, lens,
                                           scale),
        flops, io + 4 * b * mb, library, b)
    paged["library_max_abs_err"] = (library()[live]
                                    - want[live]).abs().max().item()
    paged["device_ms"] = cuda_ms(
        lambda: kda.flash_decode_paged(q, k_pool, v_pool, table, lens,
                                       scale), hide_host=True)
    paged.update(_decode_plan_fields(q, True, rows))
    paged["side"] = side
    return ring, paged


def check_flash_decode(gen, b, cfg=BASE):
    """#14 and #15 at the unfused route's shapes, the self and the cross
    side (:func:`_held_flash_decode`).  Returns {(kernel, side): record}."""
    out = {}
    for side in ("self", "cross"):
        ring, paged = _held_flash_decode(gen, b, side, cfg=cfg)
        out[("flash_decode", side)] = ring
        out[("flash_decode_paged", side)] = paged
    return out


#: the fields of a flash-decode case kept in the JSON line
FLASH_DECODE_CASE_KEYS = ("batch", "ms", "device_ms", "plain_ms",
                          "bound_ms", "bound_share", "library_ms",
                          "max_abs_err", "plan", "co_resident_grid")


def check_flash_decode_cases():
    """#14 and #15 beyond the serving batches: both sides at the ragged
    b=33 (across the plan's groups) and every lane with a full cross cache
    (256 rows) at b=64, on a generator of their own so that the other
    checks' inputs stay the parent's.  Returns {(kernel, case): record}."""
    gen = torch.Generator().manual_seed(14)
    out = {}
    for case, b, side, full in (("self b=33", 33, "self", False),
                                ("cross b=33", 33, "cross", False),
                                ("full cross b=64", 64, "cross", True)):
        ring, paged = _held_flash_decode(gen, b, side, full)
        out[("flash_decode", case)] = ring
        out[("flash_decode_paged", case)] = paged
    return out


def _paged_inputs(gen, b, full=False, cfg=BASE):
    """The paged megastep's inputs: pools of 16-row blocks behind
    shuffled tables with holes, self lengths 1-128 and cross lengths
    8-256, the last lane inactive at row 0 (self length 0) and lane 0
    with an empty cross cache when b > 1; ``full``: every lane active at
    row 127 and every cross cache full (256 rows)."""
    h, dh, L, bt = cfg["n_head"], cfg["d_key"], cfg["n_layer"], BLOCK_T
    w, ffn = _decode_weights(gen, cfg)
    stab, snb = _shuffled_table(gen, b, 128 // bt)
    ctab, cnb = _shuffled_table(gen, b, SRC_LEN // bt)
    pools = dict(cache_k=randn(gen, L, snb, bt, h, dh),
                 cache_v=randn(gen, L, snb, bt, h, dh),
                 cross_k=randn(gen, L, cnb, bt, h, dh),
                 cross_v=randn(gen, L, cnb, bt, h, dh))
    pos = torch.randint(0, 128, (b,), generator=gen)
    active = torch.ones(b, dtype=torch.int64)
    if full:
        pos[:] = 127
    elif b > 1:
        active[-1], pos[-1] = 0, 0
    ints = dict(pos=pos, lengths=pos + active)
    ints = {k: v.to(torch.int32).cuda() for k, v in ints.items()}
    ints.update(cross_lengths=_spread_lengths(gen, b, 8, SRC_LEN),
                self_table=stab, cross_table=ctab,
                active=active.to(torch.int32).cuda())
    if full:
        ints["cross_lengths"].fill_(SRC_LEN)
    x = randn(gen, b, 1, cfg["d_model"])
    return x, w, ffn, pools, ints


def check_megastep_paged(x, w, pools, ints, b, label="", cfg=BASE):
    """#12 at these inputs, as :func:`check_megastep`."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import decode_step as kds

    h, dh = cfg["n_head"], cfg["d_key"]
    name = "megastep_paged" + kernels.width_suffix(dh)
    kw = dict(layer=cfg["n_layer"] // 2, n_head=h, scale=dh ** -0.5)
    err, want, mine, plain = _held_megastep(
        f"{name}{label} b={b}",
        lambda c: kds.megastep_paged(x, **w, **c, **ints, **kw),
        lambda c: kds.reference_megastep_paged(x, **w, **c, **ints, **kw),
        pools, b)
    tables = 4 * b * (ints["self_table"].shape[1]
                      + ints["cross_table"].shape[1])
    nbytes, flops = _megastep_bytes_flops(b, ints, tables, cfg)
    rec = timed_record(
        name, "paddle_tpu_torch/csrc/megastep.cu",
        "paddle_tpu/kernels/decode_step.py:642", err,
        lambda: kds.megastep_paged(x, **w, **mine, **ints, **kw),
        lambda: kds.reference_megastep_paged(x, **w, **plain, **ints, **kw),
        flops, nbytes, None, b)
    bt = pools["cache_k"].shape[2]
    rec.update(_plan_fields(x, True, ints["self_table"].shape[1] * bt,
                            ints["cross_table"].shape[1]
                            * pools["cross_k"].shape[2], cfg))
    return rec, want


def check_paged_decode_kernels(gen, b, cfg=BASE):
    """#12 and #13 at the paged main path's shapes (:func:`_paged_inputs`)."""
    x, w, ffn, pools, ints = _paged_inputs(gen, b, cfg=cfg)
    mega, want = check_megastep_paged(x, w, pools, ints, b, cfg=cfg)
    return mega, check_ffn(want, ffn, b, "ffn_paged",
                           FFN_REPLACES["ffn_paged"], cfg=cfg)


#: the fields of a megastep or FFN case kept in the JSON line
MEGASTEP_CASE_KEYS = ("batch", "ms", "plain_ms", "bound_ms", "bound_share",
                      "max_abs_err", "plan", "co_resident_grid")
#: where the FFN records say the TPU kernel is (#11: the ring launch site,
#: #13: the paged one)
FFN_REPLACES = {
    "ffn": "paddle_tpu/kernels/decode_step.py:383",
    "ffn_paged": "paddle_tpu/kernels/decode_step.py:383 (launch :889)"}


def check_megastep_cases():
    """#10 and #12 beyond the serving batches: the ragged b=33 (across the
    plan's tile edges) and every lane with a full self (128 rows) and
    cross (256 rows) cache at b=64, on a generator of their own so that
    the other checks' inputs stay the parent's; #11 and #13 on the b=33
    megastep outputs and FFN weights of the same draws.  Returns
    {(name, case): record}."""
    gen = torch.Generator().manual_seed(33)
    out = {}
    for case, b, full in (("b=33", 33, False), ("full b=64", 64, True)):
        x, w, ffn, caches, ints = _decode_inputs(gen, b, full)
        out[("megastep", case)], y = check_megastep(x, w, caches, ints, b,
                                                    f" {case}")
        if not full:
            out[("ffn", case)] = check_ffn(y, ffn, b, "ffn",
                                           FFN_REPLACES["ffn"], " " + case)
        x, w, ffn, pools, ints = _paged_inputs(gen, b, full)
        out[("megastep_paged", case)], y = check_megastep_paged(
            x, w, pools, ints, b, f" {case}")
        if not full:
            out[("ffn_paged", case)] = check_ffn(
                y, ffn, b, "ffn_paged", FFN_REPLACES["ffn_paged"],
                " " + case)
        del caches, pools
    return out


#: phase 3 (m)'s configuration: Transformer-big's widths (Vaswani et al.
#: 2017, Table 3: d_model 1024, d_ff 4096, 6 + 6 layers) with its 1024
#: split into 8 heads of 128, vocab 32000, served as BASE is (source 256,
#: 64 greedy tokens, b 1 and 64)
BIG = dict(BASE, n_head=8, d_key=128, d_value=128, d_model=1024,
           d_inner_hid=4096)
#: the same widths as 16 heads of 64: the head-width-64 instantiations on
#: the same bytes, the yardstick of what width 128 costs
BIG64 = dict(BIG, n_head=16, d_key=64, d_value=64)
#: phase 2's decode caches at BIG's widths hold 2 layers (the kernels
#: read one; 6 would only lengthen the host's draws)
BIG_CACHE_LAYERS = 2
#: the head-width-128 kernels and their phase-2 cases: (case, b, t) for
#: #1 (b 1: clusters of 32 rows; b 64: 64 rows; t 640: the tiles route),
#: (case, b, full) for the megasteps, (case, b, side, full) for
#: flash-decode; the first case of each is the record's own
HEAD128_QKV_CASES = (("b=64", 64, SRC_LEN), ("b=1", 1, SRC_LEN),
                     ("tiles t 640", 2, 640))
HEAD128_MEGASTEP_CASES = (("b=64", 64, False), ("b=1", 1, False),
                          ("b=33", 33, False), ("full b=64", 64, True))
HEAD128_DECODE_CASES = (("cross b=64", 64, "cross", False),
                        ("self b=64", 64, "self", False),
                        ("cross b=1", 1, "cross", False),
                        ("self b=1", 1, "self", False),
                        ("cross b=33", 33, "cross", False),
                        ("self b=33", 33, "self", False),
                        ("full cross b=64", 64, "cross", True))
#: the fields of a head-width-128 case kept in the JSON line
HEAD128_CASE_KEYS = ("batch", "ms", "plain_ms", "bound_ms", "bound_by",
                     "bound_share", "library_ms", "max_abs_err", "plan",
                     "device_ms", "dh64_ms", "dh64_device_ms")


def _head128_checks(cfg, seed):
    """Phase 2's head-width cases at ``cfg``'s widths (BIG or BIG64), on a
    generator of their own: {(kernel, case): record}, the kernel named
    as at head width 64 (the FFN's records under "ffn" / "ffn_paged")."""
    gen = torch.Generator().manual_seed(seed)
    caches = dict(cfg, n_layer=BIG_CACHE_LAYERS)
    out = {}
    for case, b, t in HEAD128_QKV_CASES:
        out[("qkv_attention_fwd", case)] = check_qkv_attention(gen, b, cfg,
                                                               t)
    for case, b, full in HEAD128_MEGASTEP_CASES:
        x, w, ffn, c, ints = _decode_inputs(gen, b, full, caches)
        out[("megastep", case)], y = check_megastep(x, w, c, ints, b,
                                                    f" {case}", caches)
        if not full:
            out[("ffn", case)] = check_ffn(y, ffn, b, "ffn",
                                           FFN_REPLACES["ffn"], f" {case}",
                                           cfg)
        del c
        x, w, ffn, pools, ints = _paged_inputs(gen, b, full, caches)
        out[("megastep_paged", case)], y = check_megastep_paged(
            x, w, pools, ints, b, f" {case}", caches)
        if not full:
            out[("ffn_paged", case)] = check_ffn(
                y, ffn, b, "ffn_paged", FFN_REPLACES["ffn_paged"],
                f" {case}", cfg)
        del pools
    for case, b, side, full in HEAD128_DECODE_CASES:
        ring, paged = _held_flash_decode(gen, b, side, full, cfg)
        out[("flash_decode", case)] = ring
        out[("flash_decode_paged", case)] = paged
    torch.cuda.synchronize()
    return out


def check_head128_kernels():
    """C2 part 1 on the card: #1 (both f32 routes), #10, #12, #14, #15 and
    the FFN (#11, #13) at BIG's widths (8 heads of 128, d_model 1024),
    each at the cases above against its twin, twice for equal bits, timed
    beside its twin, its bound and (#1, #14, #15) the library call; and the
    same cases at BIG64 (16 heads of 64: the same bytes and FLOPs), whose
    kernel times each case carries as ``dh64_ms``.  Returns ({name:
    record} for the JSON line, the head-width-128 kernels' records under
    their ``_dh128`` names with their other cases under ``cases``, the
    FFN's at d_model 1024 under "ffn_dm1024" / "ffn_paged_dm1024"; every
    case's record, for printing)."""
    big = _head128_checks(BIG, 128)
    base = _head128_checks(BIG64, 64)
    records, flat = {}, []
    for (name, case), r in big.items():
        twin = base[(name, case)]
        r["dh64_ms"] = twin["ms"]
        if "device_ms" in twin:
            r["dh64_device_ms"] = twin["device_ms"]
        r["case"] = case
        flat.append(r)
        key = name + ("_dm1024" if name.startswith("ffn") else "_dh128")
        if key not in records:
            records[key] = dict(r, name=key, cases={})
        else:
            records[key]["cases"][case] = {k: r[k] for k in HEAD128_CASE_KEYS
                                           if k in r}
    return records, flat


#: C2 part 2: the training kernels at head width 128 in bf16 (part 2a,
#: amp) and in f32 (part 2b), phase 2's cases at the training path's
#: shapes (TRAIN_BATCH sequences of TRAIN_LEN at BIG's widths, and at
#: BIG64's on the same bytes).  #4-#9: (case, tq, tk, bias, causal), each
#: in bthd (#4, #6, #7) and on the same values in bhtd (#5, #8, #9, which
#: must give the bthd kernels' bits); the first is the record's (the
#: cross-attention under the source padding bias)
HEAD128_TRAIN_FLASH_CASES = (("cross", 256, 256, "pad", False),
                             ("decoder self", 256, 256, "decoder", False),
                             ("causal tq>tk, -1e30 row", 256, 128,
                              "masked", True),
                             ("ragged causal tq 129 tk 129", 129, 129,
                              "decoder", True))
#: #1 and the pair: (case, b, t, bias, causal); b None is TRAIN_BATCH (32,
#: clusters of 64 rows), b 1 takes clusters of 32, t 640 the tiles route
#: (#1); the first is the record's
HEAD128_TRAIN_QKV_CASES = (("encoder self", None, 256, "pad", False),
                           ("decoder self", None, 256, "decoder", False),
                           ("b=1 decoder self", 1, 256, "decoder", False),
                           ("causal ragged t 200, -1e30 row", 4, 200,
                            "masked", True),
                           ("tiles t 640", 2, 640, "pad", False))
#: the case of HEAD128_TRAIN_QKV_CASES on #1's tiles route, where #1 is
#: timed too
HEAD128_TILES_CASE = "tiles t 640"
#: a head-width-128 training record's fields kept for its other cases
HEAD128_TRAIN_CASE_KEYS = ("batch", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "max_abs_err",
                           "dropout_ms", "dropout_max_abs_err", "plan",
                           "dh64_ms", "dh64")


def _held(dtype):
    """How phase 2 holds a ``dtype`` kernel to its twin: (name, got,
    want) -> max abs error; bf16 by ``compare_bf16``, f32 within
    TOL_KERNEL."""
    if dtype == torch.bfloat16:
        return compare_bf16
    return lambda name, got, want: compare(name, got, want, TOL_KERNEL)


def _head128_flash(gen, cfg, case, tq, tk, bias_kind, causal, dtype):
    """#4-#9 in ``dtype`` (f32 or bf16) on one case at ``cfg``'s widths,
    rates 0 and DROPOUT: each kernel twice for equal bits and against its
    twin (``_held``), the bhtd kernels on the same values with the bthd
    kernels' bits, a row masked in the forward with dq = 0; at the record
    case timed (rate 0 and DROPOUT) beside the twin, masked SDPA (its
    backward for the walks) and the bound, and in f32 held to the twin in
    float64 (``f64_max_abs_err``: the kernel's and the f32 twin's, each
    within TOL_KERNEL).  {(kernel, case): record}."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import KERNEL_DTYPES
    from paddle_tpu_torch.kernels import attention as ka

    b, h, dh = TRAIN_BATCH, cfg["n_head"], cfg["d_key"]
    f32 = dtype == torch.float32
    held, size = _held(dtype), F32 if f32 else BF16
    scale = dh ** -0.5
    q, k, v, do, bias = [a.to(dtype).contiguous() for a in _flash_inputs(
        gen, tq, tk, bias_kind, causal, cfg)]
    t_ = [a.transpose(1, 2).contiguous() for a in (q, k, v, do)]
    errs, calls = {}, {}
    for rate in (0.0, DROPOUT):
        kw = dict(scale=scale, causal=causal, dropout_rate=rate,
                  dropout_seed=int(torch.randint(0, 2 ** 32, (1,),
                                                 generator=gen)))
        what = f"{'f32' if f32 else 'bf16'} d_head {dh} {case} rate {rate}"
        o, lse = ka.flash_fwd(q, k, v, bias, **kw)
        _require_same_bits(f"flash_fwd {what}", (o, lse),
                           ka.flash_fwd(q, k, v, bias, **kw))
        want_o, want_lse = ka.reference_flash_fwd(q, k, v, bias, **kw)
        hidden = torch.isinf(want_lse)
        require(torch.equal(hidden, torch.isinf(lse)),
                f"flash_fwd {what}: masked rows differ")
        err_f = max(held(f"flash_fwd {what}", o, want_o),
                    compare(f"flash_fwd {what} lse", lse[~hidden],
                            want_lse[~hidden], TOL_KERNEL))
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        bw = (q, k, v, bias, do, lse, delta)
        dq = ka.flash_bwd_dq(*bw, **kw)
        dk, dv = ka.flash_bwd_dkv(*bw, **kw)
        _require_same_bits(f"flash_bwd_dq {what}", (dq,),
                           (ka.flash_bwd_dq(*bw, **kw),))
        _require_same_bits(f"flash_bwd_dkv {what}", (dk, dv),
                           ka.flash_bwd_dkv(*bw, **kw))
        if bias_kind == "masked":
            require(torch.isinf(lse[-1, :, tq - 5]).all().item()
                    and not dq[-1, tq - 5].any().item(),
                    f"flash_bwd_dq {what}: the masked row's dq is not 0")
        want_dk, want_dv = ka.reference_flash_bwd_dkv(*bw, **kw)
        err_dq = held(f"flash_bwd_dq {what}", dq,
                      ka.reference_flash_bwd_dq(*bw, **kw))
        err_dkv = max(held(f"flash_bwd_dkv {what} dk", dk, want_dk),
                      held(f"flash_bwd_dkv {what} dv", dv, want_dv))
        del want_dk, want_dv
        # the bhtd kernels on the same values: the bthd kernels' bits
        bw_t = (t_[0], t_[1], t_[2], bias, t_[3], lse,
                delta.contiguous())
        o_t, lse_t = ka.flash_fwd_bhtd(t_[0], t_[1], t_[2], bias, **kw)
        dq_t = ka.flash_bwd_dq_bhtd(*bw_t, **kw)
        dk_t, dv_t = ka.flash_bwd_dkv_bhtd(*bw_t, **kw)
        for name, got, want in (("flash_fwd_bhtd", (o_t, lse_t), (o, lse)),
                                ("flash_bwd_dq_bhtd", (dq_t,), (dq,)),
                                ("flash_bwd_dkv_bhtd", (dk_t, dv_t),
                                 (dk, dv))):
            got = [a.transpose(1, 2) if a.dim() == 4 else a for a in got]
            _require_same_bits(f"{name} {what}: the bthd kernels' bits",
                               got, want)
        errs[rate] = dict(flash_fwd=err_f, flash_bwd_dq=err_dq,
                          flash_bwd_dkv=err_dkv)
        errs[rate].update({k_ + "_bhtd": e for k_, e in list(
            errs[rate].items())})
        calls[rate] = (kw, bw, bw_t, (o, lse, dq, dk, dv))
    if case != HEAD128_TRAIN_FLASH_CASES[0][0]:
        return {(name, case): dict(max_abs_err=errs[0.0][name],
                                   dropout_max_abs_err=errs[DROPOUT][name],
                                   batch=b)
                for name in errs[0.0]}
    (kw, bw, bw_t, outs), (kw_d, bw_d, bw_td, _) = calls[0.0], calls[DROPOUT]
    f64 = {}
    if f32:  # the kernels and the f32 twins against the twins in float64
        wide = [None if a is None else a.double() for a in bw]
        twins = (ka.reference_flash_fwd(*bw[:4], **kw),
                 ka.reference_flash_bwd_dq(*bw, **kw),
                 ka.reference_flash_bwd_dkv(*bw, **kw))
        exact = (ka.reference_flash_fwd(*wide[:4], **kw),
                 ka.reference_flash_bwd_dq(*wide, **kw),
                 ka.reference_flash_bwd_dkv(*wide, **kw))
        o, lse, dq, dk, dv = outs
        live = ~torch.isinf(exact[0][1])
        for name, got, twin, want in (
                ("flash_fwd", (o,), twins[0][:1], exact[0][:1]),
                ("flash_bwd_dq", (dq,), (twins[1],), (exact[1],)),
                ("flash_bwd_dkv", (dk, dv), twins[2], exact[2])):
            f64[name] = [max(compare(f"{name} f32 d_head {dh} {case} "
                                     f"against float64", a, w, TOL_KERNEL)
                             for a, w in zip(got, want)),
                         max((f.double() - w).abs().max().item()
                             for f, w in zip(twin, want))]
        f64["flash_fwd"][0] = max(f64["flash_fwd"][0], compare(
            f"flash_fwd f32 d_head {dh} {case} lse against float64",
            lse[live], exact[0][1][live], TOL_KERNEL))
        del wide, twins, exact
    lq, lk, lv = (a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias,
                                             scale=scale)
    lib_do = do.transpose(1, 2)

    def lib_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias,
                                                  scale=scale)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (lq, lk, lv), lib_do,
                                   retain_graph=True)

    pairs = _visible_pairs(tq, tk, causal)
    flops = b * h * pairs * dh
    rows, keys = size * b * h * tq * dh, size * b * h * tk * dh
    bias_bytes = size * bias.numel()
    stats = F32 * b * h * tq
    hashes = ATTN_HASH_OPS * b * h * pairs
    bound_fn = bound if f32 else bound_bf16
    sources = (("flash_walk.cuh",) * 3 if f32 else
               ("flash_tc.cuh", "flash_bwd_tc.cuh", "flash_bwd_tc.cuh"))
    out = {}
    for suffix, args in (("", (bw, bw_d)), ("_bhtd", (bw_t, bw_td))):
        for name, source, line, mult, nbytes in (
                ("flash_fwd", sources[0], 550 if not suffix else 176, 4,
                 2 * rows + 2 * keys + bias_bytes + stats),
                ("flash_bwd_dq", sources[1], 618 if not suffix else 247, 6,
                 3 * rows + 2 * keys + bias_bytes + 2 * stats),
                ("flash_bwd_dkv", sources[2], 678 if not suffix else 303, 8,
                 2 * rows + 4 * keys + bias_bytes + 2 * stats)):
            fn = getattr(ka, name + suffix)
            twin = getattr(ka, "reference_" + name + suffix)
            a0 = args[0][:3] + (bias,) if name == "flash_fwd" else args[0]
            a1 = args[1][:3] + (bias,) if name == "flash_fwd" else args[1]
            rec = timed_record(
                name + suffix + KERNEL_DTYPES[dtype]
                + ("_dh128" if dh == 128 else ""),
                "paddle_tpu_torch/csrc/" + source,
                f"paddle_tpu/kernels/attention.py:{line}",
                errs[0.0][name + suffix], lambda: fn(*a0, **kw),
                lambda: twin(*a0, **kw), mult * flops, nbytes,
                lib_fwd if name == "flash_fwd" else lib_bwd, b,
                bound_fn=bound_fn)
            rec.update(case=case, dtype="f32" if f32 else "bf16",
                       d_head=dh,
                       dropout_max_abs_err=errs[DROPOUT][name + suffix],
                       dropout_ms=cuda_ms(lambda: fn(*a1, **kw_d)),
                       dropout_bound_ms=bound_fn(mult * flops, nbytes,
                                                 hashes)[0],
                       device_ms=cuda_ms(lambda: fn(*a0, **kw),
                                         hide_host=True))
            if name in f64:
                rec["f64_max_abs_err"] = f64[name]
            out[(name + suffix, case)] = rec
    del lib_out
    return out


def _head128_qkv(gen, cfg, case, b, t, bias_kind, causal, dtype):
    """#1 and the pair #2 + #3 (and #2, #3 alone) in ``dtype`` (f32 or
    bf16) on one case at ``cfg``'s widths, rates 0 and DROPOUT: twice for
    equal bits, against the twins (``_held``), a masked row's ctx 0 and
    dx_q 0; at the record case timed beside the twins,
    ``F.multi_head_attention_forward`` in the same dtype (its backward for
    the pair) and the bounds, and in f32 the pair held to its float64 twin
    (``_held_qkv_pair_f64``, ``vs_float64``).  {(kernel, case): record},
    the pair's under "qkv_bwd"."""
    from paddle_tpu_torch.kernels import KERNEL_DTYPES
    from paddle_tpu_torch.kernels import attention as ka

    b = b or TRAIN_BATCH
    h, dh, dm = cfg["n_head"], cfg["d_key"], cfg["d_model"]
    hd = h * dh
    f32 = dtype == torch.float32
    held, size = _held(dtype), F32 if f32 else BF16
    x, w_qkv, w_out, g, bias = [a.to(dtype).contiguous() for a in
                                _qkv_inputs(gen, t, bias_kind, b, dm)]
    fw = (x, w_qkv, w_out, bias)
    errs, bws, vs_f64 = {}, {}, {}
    plan = list(ka.qkv_fwd_plan(b, t, h, ka.sm_count(x.device)))
    for rate in (0.0, DROPOUT):
        kw = dict(n_head=h, scale=dh ** -0.5, causal=causal,
                  dropout_rate=rate, dropout_seed=int(torch.randint(
                      0, 2 ** 32, (1,), generator=gen)))
        what = (f"{'f32' if f32 else 'bf16'} d_head {dh} {case} {plan} "
                f"rate {rate}")
        (y, ctx, lse), _, _, err_f = _held_qkv_fwd(
            f"qkv_attention_fwd {what}", fw, kw, bias_kind == "masked")
        bw = (x, w_qkv, w_out, bias, g, ctx, lse)
        errs[rate] = dict(qkv_attention_fwd=err_f)
        for kernel, fn, twin in (
                ("qkv_bwd", ka.qkv_bwd, ka.reference_qkv_bwd),
                ("qkv_bwd_dq", ka.qkv_bwd_dq, ka.reference_qkv_bwd_dq),
                ("qkv_bwd_dkv", ka.qkv_bwd_dkv, ka.reference_qkv_bwd_dkv)):
            got = fn(*bw, **kw)
            _require_same_bits(f"{kernel} {what}", got, fn(*bw, **kw))
            # in bf16 dx is rounded twice in the reference (dx_q + dx_kv)
            errs[rate][kernel] = max(
                held(f"{kernel} {what} part {i}", a, w)
                for i, (a, w) in enumerate(zip(got, twin(*bw, **kw))))
            if kernel == "qkv_bwd_dq" and bias_kind == "masked":
                require(torch.isinf(lse[-1, :, t - 5]).all().item()
                        and not got[0][-1, t - 5].any().item(),
                        f"{kernel} {what}: the masked row's dx_q is not 0")
            del got
        if f32 and case == HEAD128_TRAIN_QKV_CASES[0][0]:
            vs_f64[rate] = _held_qkv_pair_f64(f"qkv_bwd {what}", bw, kw)[1]
        bws[rate] = (bw, kw)
    # timed: every kernel at the record case, #1 alone on the tiles route
    timed = (tuple(errs[0.0]) if case == HEAD128_TRAIN_QKV_CASES[0][0]
             else ("qkv_attention_fwd",) if case == HEAD128_TILES_CASE
             else ())
    out = {(name, case): dict(max_abs_err=e,
                              dropout_max_abs_err=errs[DROPOUT][name],
                              batch=b, plan=plan)
           for name, e in errs[0.0].items() if name not in timed}
    if not timed:
        return out
    (bw, kw), (bw_d, kw_d) = bws[0.0], bws[DROPOUT]
    _, lib_fwd, lib_bwd = _library_mha(x, w_qkv, w_out, bias, g, h, causal)
    pairs = _visible_pairs(t, t, causal)
    proj = 2 * b * t * dm * hd
    attn = 2 * b * h * pairs * dh
    hashes = ATTN_HASH_OPS * b * h * pairs
    io = (size * (b * t * hd + dm * 3 * hd + hd * dm + bias.numel())
          + F32 * b * h * t)
    act = size * b * t * dm
    pair_bytes = (size * (3 * b * t * dm + b * t * hd + bias.numel()
                          + 2 * (dm * 3 * hd + hd * dm)) + F32 * b * h * t)
    bound_fn = bound if f32 else bound_bf16
    src = "paddle_tpu_torch/csrc/qkv_attention_bwd.cu"
    for name, source, line, fn, twin, flops, nbytes, lib in (
            ("qkv_attention_fwd", "paddle_tpu_torch/csrc/qkv_attention.cu",
             "1377", ka.qkv_attention_fwd, ka.reference_qkv_fwd,
             4 * proj + 2 * attn, 2 * act + io, lib_fwd),
            ("qkv_bwd", src, "1454 + :1546", ka.qkv_bwd,
             ka.reference_qkv_bwd, _qkv_pair_flops(proj, attn), pair_bytes,
             lib_bwd),
            ("qkv_bwd_dq", src, "1454", ka.qkv_bwd_dq,
             ka.reference_qkv_bwd_dq, 7 * proj + 3 * attn,
             3 * act + io + size * 2 * dm * hd, lib_bwd),
            ("qkv_bwd_dkv", src, "1546", ka.qkv_bwd_dkv,
             ka.reference_qkv_bwd_dkv, 8 * proj + 4 * attn,
             3 * act + io + size * 2 * dm * hd, lib_bwd)):
        if name not in timed:
            continue
        args, args_d = (fw, fw) if name == "qkv_attention_fwd" else (bw,
                                                                     bw_d)
        rec = timed_record(
            name + KERNEL_DTYPES[dtype] + ("_dh128" if dh == 128 else ""),
            source, f"paddle_tpu/kernels/attention.py:{line}",
            errs[0.0][name], lambda: fn(*args, **kw),
            lambda: twin(*args, **kw), flops, nbytes, lib, b,
            bound_fn=bound_fn)
        rec.update(case=case, dtype="f32" if f32 else "bf16", d_head=dh,
                   plan=plan, dropout_max_abs_err=errs[DROPOUT][name],
                   dropout_ms=cuda_ms(lambda: fn(*args_d, **kw_d)),
                   dropout_bound_ms=bound_fn(flops, nbytes, hashes)[0],
                   device_ms=cuda_ms(lambda: fn(*args, **kw),
                                     hide_host=True))
        if name == "qkv_bwd" and vs_f64:
            rec["vs_float64"] = vs_f64
        out[(name, case)] = rec
    del lib_fwd, lib_bwd
    return out


def _head128_train_checks(cfg, seed, dtype):
    """Phase 2's training cases in ``dtype`` at ``cfg``'s widths (BIG or
    BIG64) on a generator of their own: {(kernel, case): record}."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for case in HEAD128_TRAIN_FLASH_CASES:
        out.update(_head128_flash(gen, cfg, *case, dtype))
        torch.cuda.empty_cache()
    for case in HEAD128_TRAIN_QKV_CASES:
        out.update(_head128_qkv(gen, cfg, *case, dtype))
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return out


def check_head128_train_kernels(dtype, seed):
    """C2 part 2 on the card, in ``dtype``: #1 (clusters of 64 and 32
    rows, the tiles route), the pair #2 + #3 (and each walk alone) and
    #4-#9 at BIG's widths (8 heads of 128) on HEAD128_TRAIN_* at rates 0
    and DROPOUT against their twins, twice for equal bits, the bhtd
    kernels with the bthd kernels' bits; the record cases, and #1 on its
    tiles route (t 640), timed beside the twin, the library call and the
    bound (in f32 also held to the twins in float64); and the same cases
    at BIG64 (16 heads of 64, the same bytes and FLOPs), whose kernel
    time each timed record carries as ``dh64_ms`` (with the 64-wide
    twin's, library's and bound's under ``dh64``).  Returns ({counter name: record} for the JSON line, #2's
    and #3's carrying the pair's under "pair", each record's other cases
    under "cases"; every record, for printing)."""
    from paddle_tpu_torch.kernels import KERNEL_DTYPES

    big = _head128_train_checks(BIG, seed, dtype)
    base = _head128_train_checks(BIG64, 64, dtype)
    suffix = KERNEL_DTYPES[dtype] + "_dh128"
    records, flat = {}, []
    for (name, case), r in big.items():
        twin = base[(name, case)]
        if "ms" in twin:
            r["dh64_ms"] = twin["ms"]
            r["dh64_device_ms"] = twin["device_ms"]
            r["dh64"] = {k: twin[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err",
                "dropout_ms") if k in twin}
        r["case"] = case
        flat.append(dict(r, name=r.get("name", name + suffix)))
        key = name + suffix
        if case in (HEAD128_TRAIN_FLASH_CASES[0][0],
                    HEAD128_TRAIN_QKV_CASES[0][0]):
            records[key] = dict(r, cases=records.get(key, {}).get(
                "cases", {}))
        else:
            records.setdefault(key, {"cases": {}})["cases"][case] = {
                k: r[k] for k in HEAD128_TRAIN_CASE_KEYS if k in r}
    pair = records.pop("qkv_bwd" + suffix)
    for name in ("qkv_bwd_dq" + suffix, "qkv_bwd_dkv" + suffix):
        records[name]["pair"] = {k: pair[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "dropout_ms", "dropout_bound_ms", "device_ms",
            "dh64_ms", "vs_float64", "cases") if k in pair}
    return records, flat


#: phase 2's bthd flash-attention cases at the training path's shapes:
#: (name, tq, tk, bias, causal).  "pad" is the key-padding bias [b, 1, 1,
#: tk], "decoder" the causal-plus-padding bias [b, 1, tq, tk] (both -1e9),
#: "masked" the decoder bias with one row at -1e30; the ragged cases take
#: lengths that are multiples of neither 64 nor 128 (129 crosses the
#: forward's 128-row block by one)
FLASH_CASES = (("encoder self", 256, 256, "pad", False),
               ("decoder self", 256, 256, "decoder", False),
               ("cross trg 128 src 256", 128, 256, "pad", False),
               ("causal", 256, 256, "pad", True),
               ("causal tq>tk, -1e30 row", 256, 128, "masked", True),
               ("ragged decoder tq 200 tk 200", 200, 200, "decoder", False),
               ("ragged causal tq 136 tk 72, -1e30 row", 136, 72, "masked",
                True),
               ("ragged causal tq 129 tk 129", 129, 129, "decoder", True))
#: the case whose records go into the JSON line (the heaviest bias)
FLASH_RECORD_CASE = "decoder self"
TRAIN_BATCH, TRAIN_LEN = 32, 256


def _flash_inputs(gen, tq, tk, bias_kind, causal, cfg=BASE):
    """q, k, v, dO [b, t, h, dh] at ``cfg``'s heads (8 of 64 by default)
    and the case's bias; padded key tails of ragged lengths (row 0
    unpadded)."""
    b, h, dh = TRAIN_BATCH, cfg["n_head"], cfg["d_key"]
    q, do = randn(gen, b, tq, h, dh), randn(gen, b, tq, h, dh)
    k, v = randn(gen, b, tk, h, dh), randn(gen, b, tk, h, dh)
    lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen)
    lens[0] = tk
    pad = (torch.arange(tk)[None, :] >= lens[:, None]).float() * -1e9
    bias = pad.reshape(b, 1, 1, tk)
    if bias_kind in ("decoder", "masked"):
        future = torch.ones(tq, tk).triu(1 + tk - tq) * -1e9
        bias = bias + future.reshape(1, 1, tq, tk)
    if bias_kind == "masked":
        bias[-1, 0, tq - 5, :] = -1e30
    return q, k, v, do, bias.cuda()


def _visible_pairs(tq, tk, causal):
    """(q, k) pairs a head computes: all, or the causally visible ones."""
    if not causal:
        return tq * tk
    return int(torch.ones(tq, tk).tril(tk - tq).sum().item())


def check_flash_attention(gen):
    """#4, #6 and #7 against their plain twins on FLASH_CASES (the
    backward kernels from the forward kernel's out and lse), each called
    twice for equal bits, at rate 0 and at DROPOUT; then each
    timed beside its twin and the library yardstick: masked
    ``F.scaled_dot_product_attention`` for #4, its backward (dq, dk and
    dv together) for #6 and #7, and for both walks in one call sequence
    (``flash_bwd``).  Returns {(kernel, case): record}."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import attention as ka

    b, h, dh = TRAIN_BATCH, BASE["n_head"], BASE["d_key"]
    scale = dh ** -0.5
    out = {}
    for name, tq, tk, bias_kind, causal in FLASH_CASES:
        q, k, v, do, bias = _flash_inputs(gen, tq, tk, bias_kind, causal)
        kw = dict(scale=scale, causal=causal)
        o, lse = ka.flash_fwd(q, k, v, bias, **kw)
        _require_same_bits(f"flash_fwd {name}", (o, lse),
                           ka.flash_fwd(q, k, v, bias, **kw))
        want_o, want_lse = ka.reference_flash_fwd(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        err_fwd = compare(f"flash_fwd {name}", o, want_o, TOL_KERNEL)
        hidden = torch.isinf(want_lse)
        require(torch.equal(hidden, torch.isinf(lse)),
                f"flash_fwd {name}: masked rows differ")
        require((bias_kind == "masked") == bool(hidden.any()),
                f"flash_fwd {name}: {int(hidden.sum())} masked rows")
        err_fwd = max(err_fwd, compare(f"flash_fwd {name} lse",
                                       lse[~hidden], want_lse[~hidden],
                                       TOL_KERNEL))
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        bw = (q, k, v, bias, do, lse, delta)
        dq = ka.flash_bwd_dq(*bw, **kw)
        _require_same_bits(f"flash_bwd_dq {name}", (dq,),
                           (ka.flash_bwd_dq(*bw, **kw),))
        dk, dv = ka.flash_bwd_dkv(*bw, **kw)
        _require_same_bits(f"flash_bwd_dkv {name}", (dk, dv),
                           ka.flash_bwd_dkv(*bw, **kw))
        want_dq = ka.reference_flash_bwd_dq(*bw, **kw)
        want_dk, want_dv = ka.reference_flash_bwd_dkv(*bw, **kw)
        torch.cuda.synchronize()
        err_dq = compare(f"flash_bwd_dq {name}", dq, want_dq, TOL_KERNEL)
        err_dkv = max(compare(f"flash_bwd_dkv {name} dk", dk, want_dk,
                              TOL_KERNEL),
                      compare(f"flash_bwd_dkv {name} dv", dv, want_dv,
                              TOL_KERNEL))

        # the library yardstick: one SDPA call with the same additive mask
        mask = bias
        if causal:
            keep = torch.ones(tq, tk, dtype=torch.bool,
                              device=q.device).tril(tk - tq)
            mask = bias.masked_fill(~keep, -1e30)
        lq, lk, lv = (a.transpose(1, 2).detach().requires_grad_()
                      for a in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                                 scale=scale)
        lib_do = do.transpose(1, 2)
        live = ~hidden.transpose(1, 2)[..., None].expand_as(o)
        lib_err = (lib_out.detach().transpose(1, 2)[live]
                   - want_o[live]).abs().max().item()

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    lq, lk, lv, attn_mask=mask, scale=scale)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (lq, lk, lv), lib_do,
                                       retain_graph=True)

        pairs = _visible_pairs(tq, tk, causal)
        rows = F32 * b * h * (tq * dh)  # one [b, tq, h, dh] tensor
        keys = F32 * b * h * (tk * dh)
        bias_bytes = F32 * bias.numel()
        stats = F32 * 2 * b * h * tq  # lse and delta
        src = "paddle_tpu_torch/csrc/flash_attention.cu"
        flops = b * h * pairs * dh
        out[("flash_fwd", name)] = timed_record(
            "flash_fwd", src, "paddle_tpu/kernels/attention.py:550",
            err_fwd, lambda: ka.flash_fwd(q, k, v, bias, **kw),
            lambda: ka.reference_flash_fwd(q, k, v, bias, **kw), 4 * flops,
            2 * rows + 2 * keys + bias_bytes + stats // 2, lib_fwd, b)
        out[("flash_fwd", name)]["library_max_abs_err"] = lib_err
        out[("flash_bwd_dq", name)] = timed_record(
            "flash_bwd_dq", src, "paddle_tpu/kernels/attention.py:618",
            err_dq, lambda: ka.flash_bwd_dq(*bw, **kw),
            lambda: ka.reference_flash_bwd_dq(*bw, **kw), 6 * flops,
            3 * rows + 2 * keys + bias_bytes + stats, lib_bwd, b)
        out[("flash_bwd_dkv", name)] = timed_record(
            "flash_bwd_dkv", src, "paddle_tpu/kernels/attention.py:678",
            err_dkv, lambda: ka.flash_bwd_dkv(*bw, **kw),
            lambda: ka.reference_flash_bwd_dkv(*bw, **kw), 8 * flops,
            2 * rows + 4 * keys + bias_bytes + stats, lib_bwd, b)
        out[("flash_bwd", name)] = flash_bwd_record(
            "paddle_tpu/kernels/attention.py:618, :678",
            max(err_dq, err_dkv), lambda: (ka.flash_bwd_dq(*bw, **kw),
                                           ka.flash_bwd_dkv(*bw, **kw)),
            lambda: (ka.reference_flash_bwd_dq(*bw, **kw),
                     ka.reference_flash_bwd_dkv(*bw, **kw)), flops,
            3 * rows + 4 * keys + bias_bytes + stats, lib_bwd, b)
        del lib_out

        # weights dropout at DROPOUT under one seed: the same checks, the
        # backward from the dropped output, then each kernel timed
        dkw = dict(kw, dropout_rate=DROPOUT, dropout_seed=int(
            torch.randint(0, 2 ** 32, (1,), generator=gen)))
        o_d, lse_d = ka.flash_fwd(q, k, v, bias, **dkw)
        _require_same_bits(f"flash_fwd {name} dropout", (o_d, lse_d),
                           ka.flash_fwd(q, k, v, bias, **dkw))
        want_od, want_lsed = ka.reference_flash_fwd(q, k, v, bias, **dkw)
        torch.cuda.synchronize()
        require(torch.equal(torch.isinf(lse_d), hidden),
                f"flash_fwd {name} dropout: masked rows differ")
        require(not torch.allclose(o_d, o, atol=1e-3),
                f"flash_fwd {name}: dropout changed nothing")
        errs = [max(compare(f"flash_fwd {name} dropout", o_d, want_od,
                            TOL_KERNEL),
                    compare(f"flash_fwd {name} dropout lse", lse_d[~hidden],
                            want_lsed[~hidden], TOL_KERNEL))]
        delta_d = (do * o_d).sum(-1).transpose(1, 2).contiguous()
        bw_d = (q, k, v, bias, do, lse_d, delta_d)
        dq_d = ka.flash_bwd_dq(*bw_d, **dkw)
        _require_same_bits(f"flash_bwd_dq {name} dropout", (dq_d,),
                           (ka.flash_bwd_dq(*bw_d, **dkw),))
        dk_d, dv_d = ka.flash_bwd_dkv(*bw_d, **dkw)
        _require_same_bits(f"flash_bwd_dkv {name} dropout", (dk_d, dv_d),
                           ka.flash_bwd_dkv(*bw_d, **dkw))
        want_dk, want_dv = ka.reference_flash_bwd_dkv(*bw_d, **dkw)
        errs.append(compare(f"flash_bwd_dq {name} dropout", dq_d,
                            ka.reference_flash_bwd_dq(*bw_d, **dkw),
                            TOL_KERNEL))
        errs.append(max(compare(f"flash_bwd_dkv {name} dropout dk", dk_d,
                                want_dk, TOL_KERNEL),
                        compare(f"flash_bwd_dkv {name} dropout dv", dv_d,
                                want_dv, TOL_KERNEL)))
        del want_dk, want_dv
        hashes = ATTN_HASH_OPS * b * h * pairs
        for kernel, err, fn, mult, nbytes in (
                ("flash_fwd", errs[0],
                 lambda: ka.flash_fwd(q, k, v, bias, **dkw), 4,
                 2 * rows + 2 * keys + bias_bytes + stats // 2),
                ("flash_bwd_dq", errs[1],
                 lambda: ka.flash_bwd_dq(*bw_d, **dkw), 6,
                 3 * rows + 2 * keys + bias_bytes + stats),
                ("flash_bwd_dkv", errs[2],
                 lambda: ka.flash_bwd_dkv(*bw_d, **dkw), 8,
                 2 * rows + 4 * keys + bias_bytes + stats)):
            out[(kernel, name)].update(
                dropout_max_abs_err=err, dropout_ms=cuda_ms(fn),
                dropout_bound_ms=bound(mult * flops, nbytes, hashes)[0])
    return out


#: BERT-base as the reference's ``bench_bert`` runs it (``run_bert``):
#: 12 layers, 12 heads of 64, d_model 768, d_ff 3072, vocab 30522, seq 128,
#: batch 128, dropout 0.1, Adam 1e-4; f32 where the bench runs amp
BERT = dict(vocab_size=30522, seq_len=128, n_layer=12, n_head=12,
            d_model=768, d_ff=3072)
BERT_BATCH, BERT_LR, BERT_TIMED_STEPS = 128, 1e-4, 10
#: (i): the batch of step 1's CPU copies (float64 and f32)
BERT_PARITY_BATCH = 4
#: phase 2's bhtd flash-attention cases (#5, #8, #9) at BERT-base's
#: self-attention shapes, q, k, v [128, 12, t, 64]: (name, tq, tk, bias,
#: causal).  "pad" is BERT's key-padding bias [b, 1, 1, tk] (-1e9 on
#: ragged tails), "head" that plus a per-head bias [b, h, tq, tk] that
#: requires grad (the dbias path), "masked" the padding bias as [b, 1, tq,
#: tk] with one row at -1e30; the ragged cases take lengths that are
#: multiples of neither 64 nor 128 (129 crosses the forward's 128-row block
#: by one)
BHTD_CASES = (("bert self", 128, 128, "pad", False),
              ("per-head trainable bias", 128, 128, "head", False),
              ("causal", 128, 128, "pad", True),
              ("causal tq>tk, -1e30 row", 128, 64, "masked", True),
              ("cross tq 64 tk 128", 64, 128, "pad", False),
              ("ragged tq 72 tk 200", 72, 200, "pad", False),
              ("ragged causal tq 200 tk 136", 200, 136, "pad", True),
              ("ragged tq 129 tk 72", 129, 72, "pad", False))
#: the case whose records go into the JSON line (the main path's)
BHTD_RECORD_CASE = "bert self"


def _bhtd_inputs(gen, tq, tk, bias_kind):
    """q, dO [b, h, tq, 64], k, v [b, h, tk, 64] and the case's bias; padded
    key tails of ragged lengths (row 0 unpadded)."""
    b, h, dh = BERT_BATCH, BERT["n_head"], 64
    q, do = randn(gen, b, h, tq, dh), randn(gen, b, h, tq, dh)
    k, v = randn(gen, b, h, tk, dh), randn(gen, b, h, tk, dh)
    lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen)
    lens[0] = tk
    pad = (torch.arange(tk)[None, :] >= lens[:, None]).float() * -1e9
    bias = pad.reshape(b, 1, 1, tk)
    if bias_kind == "head":
        bias = bias + torch.randn(b, h, tq, tk, generator=gen) * 0.5
    if bias_kind == "masked":
        bias = bias.expand(b, 1, tq, tk).clone()
        bias[-1, 0, tq - 5, :] = -1e30
    return q, k, v, do, bias.cuda()


def check_flash_attention_bhtd(gen):
    """#5, #8 and #9 against their plain twins on BHTD_CASES, at rate 0 and
    at DROPOUT under one seed, each kernel called twice for equal bits
    (the backward kernels from the forward kernel's out and lse); the
    trainable per-head bias also through ``flash_attention(fmt="bhtd")``'s
    autograd against autograd through the forward twin (dq, dk, dv and
    dbias).  Each kernel is then timed beside its twin and the library
    yardstick: ``F.scaled_dot_product_attention`` on the same [b, h, t, d]
    tensors with the bias (and the causal mask) as a float ``attn_mask``
    for #5, its backward (dq, dk and dv together) for #8 and #9, and for
    both walks in one call sequence (``flash_bwd_bhtd``).  Returns
    {(kernel, case): record}."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import attention as ka

    b, h, dh = BERT_BATCH, BERT["n_head"], 64
    scale = dh ** -0.5
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    replaces = {"flash_fwd_bhtd": "paddle_tpu/kernels/attention.py:176",
                "flash_bwd_dq_bhtd": "paddle_tpu/kernels/attention.py:247",
                "flash_bwd_dkv_bhtd": "paddle_tpu/kernels/attention.py:303"}
    out = {}
    for name, tq, tk, bias_kind, causal in BHTD_CASES:
        q, k, v, do, bias = _bhtd_inputs(gen, tq, tk, bias_kind)
        kw = dict(scale=scale, causal=causal)
        seed = int(torch.randint(0, 2 ** 32, (1,), generator=gen))
        errs, calls, o_rate0 = {}, {}, None
        for rate in (0.0, DROPOUT):
            rkw = dict(kw, dropout_rate=rate, dropout_seed=seed if rate else 0)
            tag = f"{name} rate {rate}"
            o, lse = ka.flash_fwd_bhtd(q, k, v, bias, **rkw)
            _require_same_bits(f"flash_fwd_bhtd {tag}", (o, lse),
                               ka.flash_fwd_bhtd(q, k, v, bias, **rkw))
            want_o, want_lse = ka.reference_flash_fwd_bhtd(q, k, v, bias,
                                                           **rkw)
            torch.cuda.synchronize()
            hidden = torch.isinf(want_lse)
            require(torch.equal(hidden, torch.isinf(lse)),
                    f"flash_fwd_bhtd {tag}: masked rows differ")
            require(bool(hidden.any()) == (causal and tq > tk),
                    f"flash_fwd_bhtd {tag}: {int(hidden.sum())} masked rows")
            err_fwd = max(compare(f"flash_fwd_bhtd {tag}", o, want_o,
                                  TOL_KERNEL),
                          compare(f"flash_fwd_bhtd {tag} lse", lse[~hidden],
                                  want_lse[~hidden], TOL_KERNEL))
            if rate:
                require(not torch.allclose(o, o_rate0, atol=1e-3),
                        f"flash_fwd_bhtd {name}: dropout changed nothing")
            o_rate0 = o
            delta = (do * o).sum(-1).contiguous()
            bw = (q, k, v, bias, do, lse, delta)
            dq = ka.flash_bwd_dq_bhtd(*bw, **rkw)
            _require_same_bits(f"flash_bwd_dq_bhtd {tag}", (dq,),
                               (ka.flash_bwd_dq_bhtd(*bw, **rkw),))
            dk, dv = ka.flash_bwd_dkv_bhtd(*bw, **rkw)
            _require_same_bits(f"flash_bwd_dkv_bhtd {tag}", (dk, dv),
                               ka.flash_bwd_dkv_bhtd(*bw, **rkw))
            err_dq = compare(f"flash_bwd_dq_bhtd {tag}", dq,
                             ka.reference_flash_bwd_dq_bhtd(*bw, **rkw),
                             TOL_KERNEL)
            want_dk, want_dv = ka.reference_flash_bwd_dkv_bhtd(*bw, **rkw)
            err_dkv = max(compare(f"flash_bwd_dkv_bhtd {tag} dk", dk,
                                  want_dk, TOL_KERNEL),
                          compare(f"flash_bwd_dkv_bhtd {tag} dv", dv,
                                  want_dv, TOL_KERNEL))
            del want_o, want_dk, want_dv
            errs[rate] = dict(flash_fwd_bhtd=err_fwd, flash_bwd_dq_bhtd=err_dq,
                              flash_bwd_dkv_bhtd=err_dkv)
            calls[rate] = dict(
                flash_fwd_bhtd=lambda rkw=rkw: ka.flash_fwd_bhtd(
                    q, k, v, bias, **rkw),
                flash_bwd_dq_bhtd=lambda bw=bw, rkw=rkw: ka.flash_bwd_dq_bhtd(
                    *bw, **rkw),
                flash_bwd_dkv_bhtd=lambda bw=bw, rkw=rkw: ka.
                flash_bwd_dkv_bhtd(*bw, **rkw))
            if bias_kind == "head":
                # the Function: dbias by the plain recompute, the rest by
                # the kernels, against autograd through the forward twin
                grads = []
                for fn in (lambda *a: ka.flash_attention(*a, fmt="bhtd",
                                                         **rkw),
                           lambda *a: ka.reference_flash_fwd_bhtd(
                               *a, **rkw)[0]):
                    args = [a.detach().clone().requires_grad_()
                            for a in (q, k, v, bias)]
                    fn(*args).backward(do)
                    grads.append([a.grad for a in args])
                for what, got, want in zip(("dq", "dk", "dv", "dbias"),
                                           *grads):
                    compare(f"flash_attention bhtd {tag} autograd {what}",
                            got, want, TOL_KERNEL)
                del grads

        # the library yardstick: SDPA on the same tensors and mask
        mask = bias
        if causal:
            keep = torch.ones(tq, tk, dtype=torch.bool,
                              device=q.device).tril(tk - tq)
            mask = bias.masked_fill(~keep, -1e30)
        lq, lk, lv = (a.detach().requires_grad_() for a in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                                 scale=scale)
        want_o0, want_lse0 = ka.reference_flash_fwd_bhtd(q, k, v, bias, **kw)
        lib_err = (lib_out.detach() - want_o0)[
            ~torch.isinf(want_lse0)].abs().max().item()
        del want_o0, want_lse0

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    lq, lk, lv, attn_mask=mask, scale=scale)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                       retain_graph=True)

        pairs = _visible_pairs(tq, tk, causal)
        rows = F32 * b * h * tq * dh  # one [b, h, tq, dh] tensor
        keys = F32 * b * h * tk * dh
        bias_bytes = F32 * bias.numel()
        stats = F32 * 2 * b * h * tq  # lse and delta
        flops = b * h * pairs * dh
        hashes = ATTN_HASH_OPS * b * h * pairs
        o0, lse0 = ka.flash_fwd_bhtd(q, k, v, bias, **kw)
        bw0 = (q, k, v, bias, do, lse0, (do * o0).sum(-1).contiguous())
        plain = dict(
            flash_fwd_bhtd=lambda: ka.reference_flash_fwd_bhtd(q, k, v, bias,
                                                               **kw),
            flash_bwd_dq_bhtd=lambda: ka.reference_flash_bwd_dq_bhtd(
                *bw0, **kw),
            flash_bwd_dkv_bhtd=lambda: ka.reference_flash_bwd_dkv_bhtd(
                *bw0, **kw))
        for kernel, mult, nbytes, lib in (
                ("flash_fwd_bhtd", 4,
                 2 * rows + 2 * keys + bias_bytes + stats // 2, lib_fwd),
                ("flash_bwd_dq_bhtd", 6,
                 3 * rows + 2 * keys + bias_bytes + stats, lib_bwd),
                ("flash_bwd_dkv_bhtd", 8,
                 2 * rows + 4 * keys + bias_bytes + stats, lib_bwd)):
            r = timed_record(kernel, src, replaces[kernel], errs[0.0][kernel],
                             calls[0.0][kernel], plain[kernel], mult * flops,
                             nbytes, lib, b)
            r.update(dropout_max_abs_err=errs[DROPOUT][kernel],
                     dropout_ms=cuda_ms(calls[DROPOUT][kernel]),
                     dropout_bound_ms=bound(mult * flops, nbytes,
                                            hashes)[0])
            if kernel == "flash_fwd_bhtd":
                r["library_max_abs_err"] = lib_err
            out[(kernel, name)] = r
        out[("flash_bwd_bhtd", name)] = flash_bwd_record(
            "paddle_tpu/kernels/attention.py:247, :303",
            max(errs[0.0]["flash_bwd_dq_bhtd"],
                errs[0.0]["flash_bwd_dkv_bhtd"]),
            lambda: (calls[0.0]["flash_bwd_dq_bhtd"](),
                     calls[0.0]["flash_bwd_dkv_bhtd"]()),
            lambda: (plain["flash_bwd_dq_bhtd"](),
                     plain["flash_bwd_dkv_bhtd"]()), flops,
            3 * rows + 4 * keys + bias_bytes + stats, lib_bwd, b)
        del lib_out, calls, bw0
    return out


#: phase 2's fused-projection training cases (#1 with residuals, #2, #3)
#: at the training path's shapes: (name, t, bias, causal).  "pad" is the
#: key-padding bias [b, 1, 1, t], "decoder" the causal-plus-padding bias
#: [b, 1, t, t] (both -1e9), "masked" the decoder bias with one row at
#: -1e30 on every key
QKV_CASES = (("encoder self", 256, "pad", False),
             ("decoder self", 256, "decoder", False),
             ("causal", 256, None, True),
             ("ragged t 200, -1e30 row", 200, "masked", False))
QKV_RECORD_CASE = "decoder self"


def _qkv_inputs(gen, t, bias_kind, b=None, dm=None):
    """x, g = dL/dy [b, t, d_model], the packed weights and the case's
    bias; padded key tails of ragged lengths (row 0 unpadded).  b and
    d_model default to the training step's (TRAIN_BATCH, BASE), the heads
    to d_model / 64 of width 64."""
    b, dm = b or TRAIN_BATCH, dm or BASE["d_model"]
    hd = dm
    x, g = randn(gen, b, t, dm), randn(gen, b, t, dm)
    w_qkv = randn(gen, dm, 3 * hd, scale=dm ** -0.5)
    w_out = randn(gen, hd, dm, scale=hd ** -0.5)
    if bias_kind is None:
        return x, w_qkv, w_out, g, None
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen)
    lens[0] = t
    bias = ((torch.arange(t)[None, :] >= lens[:, None]).float()
            * -1e9).reshape(b, 1, 1, t)
    if bias_kind in ("decoder", "masked"):
        bias = bias + (torch.ones(t, t).triu(1) * -1e9).reshape(1, 1, t, t)
    if bias_kind == "masked":
        bias[-1, 0, t - 5, :] = -1e30
    return x, w_qkv, w_out, g, bias.cuda()


def _library_mha(x, w_qkv, w_out, bias, g, n_head, causal):
    """One ``F.multi_head_attention_forward`` call on the same weights and
    additive mask (a yardstick only): (its y [b, t, dm], the no-grad
    forward, the backward giving dx, dW_in and dW_out together)."""
    import torch.nn.functional as F

    b, t, dm = x.shape
    mask = torch.zeros(1, 1, t, t, device=x.device, dtype=x.dtype)
    if bias is not None:
        mask = mask + bias
    if causal:
        mask = mask.masked_fill(torch.ones(t, t, dtype=torch.bool,
                                           device=x.device).triu(1), -1e30)
    mask = mask.expand(b, n_head, t, t).reshape(b * n_head, t, t)
    lx = x.transpose(0, 1).detach().requires_grad_()
    w_in = w_qkv.t().contiguous().requires_grad_()
    w_o = w_out.t().contiguous().requires_grad_()

    def call():
        return F.multi_head_attention_forward(
            lx, lx, lx, dm, n_head, w_in, None, None, None, False, 0.0, w_o,
            None, training=False, attn_mask=mask, need_weights=False)[0]

    out = call()
    lg = g.transpose(0, 1)

    def fwd():
        with torch.no_grad():
            return call()

    def bwd():
        return torch.autograd.grad(out, (lx, w_in, w_o), lg,
                                   retain_graph=True)

    return out.detach().transpose(0, 1), fwd, bwd


def _held_qkv_fwd(what, fw, kw, masked):
    """#1 in residual mode on ``fw`` under ``kw``, called twice: equal
    bits, the twin's masked rows (some exactly when ``masked``) with ctx 0
    and lse +inf, and y and ctx within TOL_KERNEL of the twin (bf16: by
    ``compare_bf16``), the other rows' lse within TOL_KERNEL.  Returns
    ((y, ctx, lse), the twin's, the masked rows [b, h, t], the max abs
    error)."""
    from paddle_tpu_torch.kernels import attention as ka

    got = ka.qkv_attention_fwd(*fw, **kw)
    again = ka.qkv_attention_fwd(*fw, **kw)
    want = ka.reference_qkv_fwd(*fw, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(got, again)),
            f"{what}: two calls on the same inputs differ")
    (y, ctx, lse), (want_y, want_ctx, want_lse) = got, want
    hidden = torch.isinf(want_lse)
    require(torch.equal(hidden, torch.isinf(lse)),
            f"{what}: masked rows differ")
    require(masked == bool(hidden.any()),
            f"{what}: {int(hidden.sum())} masked rows")
    require(not ctx[hidden.transpose(1, 2)].any().item(),
            f"{what}: a masked row's ctx is not 0")
    if y.dtype == torch.bfloat16:
        err = max(compare_bf16(f"{what} y", y, want_y),
                  compare_bf16(f"{what} ctx", ctx, want_ctx))
    else:
        err = max(compare(f"{what} y", y, want_y, TOL_KERNEL),
                  compare(f"{what} ctx", ctx, want_ctx, TOL_KERNEL))
    err = max(err, compare(f"{what} lse", lse[~hidden], want_lse[~hidden],
                           TOL_KERNEL))
    return got, want, hidden, err


def _qkv_bwd_bytes(b, t, dm, h, bias):
    """Bytes the pair #2 + #3 must move: x, g and dx [b, t, dm], ctx [b,
    t, hd], lse, the bias, w_qkv and w_out in, dW_qkv and dW_out out."""
    hd = h * 64
    return F32 * (3 * b * t * dm + b * t * hd + b * h * t
                  + 2 * (dm * 3 * hd + hd * dm)
                  + (bias.numel() if bias is not None else 0))


def _qkv_pair_flops(proj, attn):
    """f32 FLOPs the pair #2 + #3 must do, from one projection-sized
    product ``proj`` and one t x t product of every head ``attn``: 11 of
    the first (q|k|v, dctx, dx over 3hd, dW_qkv, dW_out) and 5 of the
    second (s and dp once, dq, dk, dv).  The kernel's dkv walk computes s
    and dp again: that is its layout's overhead, not the function's
    work."""
    return 11 * proj + 5 * attn


def _held_qkv_pair(what, bw, kw, rows, dx_kv=None):
    """The pair #2 + #3 (``qkv_bwd``) on ``bw`` under ``kw``, called twice:
    equal bits, and dx, dW_qkv and dW_out within TOL_KERNEL of
    ``reference_qkv_bwd``.  On the masked rows ``rows`` [b, t] (query rows
    the forward masked) the dq walk contributes exact zeros, so dx there
    must equal #3's ``dx_kv`` bit for bit where it is given.  Returns the
    max abs error."""
    from paddle_tpu_torch.kernels import attention as ka

    got = ka.qkv_bwd(*bw, **kw)
    again = ka.qkv_bwd(*bw, **kw)
    want = ka.reference_qkv_bwd(*bw, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(got, again)),
            f"{what}: two calls on the same inputs differ")
    err = max(compare(f"{what} {part}", a, w, TOL_KERNEL)
              for part, a, w in zip(("dx", "dW_qkv", "dW_out"), got, want))
    if dx_kv is not None and rows.any():
        require(torch.equal(got[0][rows], dx_kv[rows]),
                f"{what}: a masked row's dx is not #3's dx_kv (the dq walk "
                f"gave it a nonzero part)")
    return err


#: the pair's BERT-base case: (name, b, t, d_model, bias, causal), the
#: self-attention of phase 3 (i)'s ``use_flash`` route
QKV_PAIR_BERT = ("bert self", 128, 128, 768, "pad", False)


def _normwise(name, got, exact, tol):
    """Max abs error of ``got`` against the float64 ``exact``; raises
    unless it is within ``tol`` of exact's largest magnitude."""
    require(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    err = (got.double() - exact).abs().max().item()
    scale = exact.abs().max().item()
    require(err <= tol * scale, f"{name}: max abs err {err} over {tol} of "
                                f"its largest magnitude {scale}")
    return err


def _held_qkv_pair_f64(what, bw, kw):
    """The pair on ``bw`` under ``kw``, twice for equal bits, against the
    twin in float64 on the same inputs (#1's f32 residuals included): dx
    within TOL_KERNEL elementwise, dW_qkv and dW_out (sums over all b*t
    rows) within TOL_KERNEL of their largest magnitude, and each part
    within TOL_KERNEL elementwise of the f32 twin on the card.  The dW's
    hold elementwise against the twin because ``gemm.cuh`` sums BERT-base's
    16384 rows in slabs of at most 1024 (C13); in one f32 sum per 8192 rows
    their near-zero elements would not.  Returns the max abs error and
    {part: (the kernel's max abs error, the f32 twin's on the card, the
    kernel's largest excess over TOL_KERNEL against the twin
    elementwise)}, the first two against float64: the twin's is the
    library's own at this shape."""
    from paddle_tpu_torch.kernels import attention as ka

    got = ka.qkv_bwd(*bw, **kw)
    again = ka.qkv_bwd(*bw, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(got, again)),
            f"{what}: two calls on the same inputs differ")
    del again
    exact = ka.reference_qkv_bwd(
        *(None if a is None else a.double() for a in bw), **kw)
    twin = ka.reference_qkv_bwd(*bw, **kw)
    parts = {}
    for part, a, w, f in zip(("dx", "dW_qkv", "dW_out"), got, exact, twin):
        err = (compare(f"{what} dx", a, w, TOL_KERNEL) if part == "dx"
               else _normwise(f"{what} {part}", a, w, TOL_KERNEL))
        # the kernel against the f32 twin elementwise: the largest of
        # |got - twin| - TOL_KERNEL * |twin|, within TOL_KERNEL
        off = ((a - f).abs() - TOL_KERNEL * f.abs()).max().item()
        compare(f"{what} {part} against the f32 twin", a, f, TOL_KERNEL)
        parts[part] = (err, (f.double() - w).abs().max().item(), off)
    return max(p[0] for p in parts.values()), parts


def check_qkv_pair_bert(gen):
    """The pair #2 + #3 at BERT-base's self-attention (QKV_PAIR_BERT)
    against its float64 twin at rates 0 and DROPOUT
    (``_held_qkv_pair_f64``), each called twice for equal bits, and timed
    beside its f32 twin, its bound and the library backward.  Returns the
    record."""
    from paddle_tpu_torch.kernels import attention as ka

    name, b, t, dm, bias_kind, causal = QKV_PAIR_BERT
    h, dh = dm // 64, 64
    x, w_qkv, w_out, g, bias = _qkv_inputs(gen, t, bias_kind, b, dm)
    kw = dict(n_head=h, scale=dh ** -0.5, causal=causal)
    fw = (x, w_qkv, w_out, bias)
    errs, bws, vs_f64 = {}, {}, {}
    for rate in (0.0, DROPOUT):
        rkw = dict(kw, dropout_rate=rate, dropout_seed=int(torch.randint(
            0, 2 ** 32, (1,), generator=gen)))
        _, ctx, lse = ka.qkv_attention_fwd(*fw, **rkw)
        bws[rate] = ((x, w_qkv, w_out, bias, g, ctx, lse), rkw)
        errs[rate], vs_f64[rate] = _held_qkv_pair_f64(
            f"qkv_bwd {name} rate {rate}", bws[rate][0], rkw)
    _, _, lib_bwd = _library_mha(x, w_qkv, w_out, bias, g, h, causal)
    pairs = _visible_pairs(t, t, causal)
    flops = _qkv_pair_flops(2 * b * t * dm * dm, 2 * b * h * pairs * dh)
    nbytes = _qkv_bwd_bytes(b, t, dm, h, bias)
    bw, rkw = bws[0.0]
    rec = timed_record(
        "qkv_bwd", "paddle_tpu_torch/csrc/qkv_attention_bwd.cu",
        "paddle_tpu/kernels/attention.py:1454 + :1546", errs[0.0],
        lambda: ka.qkv_bwd(*bw, **rkw),
        lambda: ka.reference_qkv_bwd(*bw, **rkw), flops, nbytes, lib_bwd, b)
    bw_d, dkw = bws[DROPOUT]
    rec.update(case=name, t=t, d_model=dm, dropout_max_abs_err=errs[DROPOUT],
               # {rate: {part: (kernel, f32 twin, kernel - twin excess)}}:
               # max abs against float64, then the elementwise excess
               vs_float64=vs_f64,
               dropout_ms=cuda_ms(lambda: ka.qkv_bwd(*bw_d, **dkw)),
               dropout_bound_ms=bound(flops, nbytes,
                                      ATTN_HASH_OPS * b * h * pairs)[0])
    return rec


def check_gemm(gen):
    """``gemm.cuh``'s tile alone (``kernels.gemm.gemm``, ``csrc/gemm.cu``)
    at the pair's record-case products (GEMM_CASES, in the layouts the
    pair gives them) and at BERT-base's dW_qkv (GEMM_BERT_DW): within
    TOL_KERNEL of ``torch.matmul`` (TF32 off), equal bits on a repeat,
    timed beside it.  Returns the records, each with its TFLOP/s and share
    of the f32 peak beside ``torch.matmul``'s and the depth of the slab it
    sums in one running f32 sum (C13's bound); the BERT case also with
    both products' max abs error against the product in float64."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import gemm as kg
    from paddle_tpu_torch.kernels.attention import sm_count

    out = []
    for name, m, n, k, a_t, b_t, split in GEMM_CASES + (GEMM_BERT_DW,):
        # a scaled by K^-1/2, as the weights are: c of unit size
        a = (randn(gen, k, m, scale=k ** -0.5).t() if a_t
             else randn(gen, m, k, scale=k ** -0.5))
        b = randn(gen, n, k).t() if b_t else randn(gen, k, n)
        got, again = kg.gemm(a, b, split), kg.gemm(a, b, split)
        want = torch.matmul(a, b)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"gemm {name}: two calls differ")
        err = compare(f"gemm {name}", got, want, TOL_KERNEL)
        f64 = None
        if (name, m, n, k, a_t, b_t, split) == GEMM_BERT_DW:
            exact = torch.matmul(a.double(), b.double())
            f64 = dict(kernel=(got.double() - exact).abs().max().item(),
                       matmul=(want.double() - exact).abs().max().item())
            del exact
        flops = 2 * m * n * k
        rec = timed_record(
            "gemm", "paddle_tpu_torch/csrc/gemm.cuh",
            "none: the f32 tile inside #1's y, #2 + #3 and #19", err,
            lambda: kg.gemm(a, b, split), lambda: kg.reference_gemm(a, b),
            flops, F32 * (m * k + k * n + m * n), lambda: torch.matmul(a, b),
            m)
        rec.update(case=name, m=m, n=n, k=k, a_kmajor=a_t, b_kmajor=not b_t,
                   slab=_build.lib().ptt_gemm_slab(m, n, k, sm_count(
                       a.device)) if split else k,
                   tflops=flops / rec["ms"] / 1e9,
                   peak_share=flops / rec["ms"] / 1e9 / PEAK_F32_FLOPS
                   * 1e12,
                   matmul_tflops=flops / rec["library_ms"] / 1e9)
        if f64 is not None:
            rec["vs_float64"] = f64
        out.append(rec)
        del a, b, got, again, want
    for name, m, n, k, a_t, b_t, split, a_bf, b_bf, c_bf in GEMM_AMP_CASES:
        a = (randn(gen, k, m, scale=k ** -0.5).t() if a_t
             else randn(gen, m, k, scale=k ** -0.5))
        b = randn(gen, n, k).t() if b_t else randn(gen, k, n)
        a, b = (a.t().contiguous().t() if t_ else a.contiguous()
                for a, t_ in ((a, a_t), (b, b_t)))
        # bf16, or an f32 operand as the hi/lo planes the pair holds
        a = a.bfloat16() if a_bf else kg.hi_lo(a)
        b = b.bfloat16() if b_bf else kg.hi_lo(b)
        c_dtype = torch.bfloat16 if c_bf else torch.float32
        got = kg.gemm(a, b, split, c_dtype)
        again = kg.gemm(a, b, split, c_dtype)
        want = kg.reference_gemm(a, b, c_dtype)
        torch.cuda.synchronize()
        require(got.dtype == c_dtype and torch.equal(got, again),
                f"gemm {name}: dtype or repeat differs")
        err = (compare_bf16(f"gemm {name}", got, want) if c_bf
               else compare(f"gemm {name}", got, want, TOL_KERNEL))
        la, lb = (x.hi if isinstance(x, kg.HiLo) else x for x in (a, b))
        flops = 2 * m * n * k
        # an operand's bytes as the product reads them (hi/lo planes: 4)
        nbytes = ((2 if a_bf else 4) * m * k + (2 if b_bf else 4) * k * n
                  + got.element_size() * m * n)
        rec = timed_record(
            "gemm", "paddle_tpu_torch/csrc/gemm.cuh",
            "none: the tensor-core tile of #1's y and #2 + #3's five "
            "products in bf16 (amp)", err,
            lambda: kg.gemm(a, b, split, c_dtype),
            lambda: kg.reference_gemm(a, b, c_dtype), flops, nbytes,
            lambda: torch.matmul(la, lb), m, bound_fn=bound_bf16)
        rec["device_ms"] = cuda_ms(lambda: kg.gemm(a, b, split, c_dtype),
                                   hide_host=True)
        rec["library_device_ms"] = cuda_ms(lambda: torch.matmul(la, lb),
                                           hide_host=True)
        rec.update(case=name, m=m, n=n, k=k, a_kmajor=a_t, b_kmajor=not b_t,
                   dtypes=["bf16" if bf else "f32 (hi/lo bf16 planes)"
                           for bf in (a_bf, b_bf)] + [str(got.dtype)[6:]],
                   mma_flops=flops * (1 if a_bf and b_bf else 2),
                   device_tflops=flops / rec["device_ms"] / 1e9,
                   matmul_device_tflops=flops / rec["library_device_ms"]
                   / 1e9,
                   tflops=flops / rec["ms"] / 1e9,
                   bf16_peak_share=flops / rec["ms"] / 1e9
                   / PEAK_BF16_FLOPS * 1e12,
                   peak_share=flops / rec["ms"] / 1e9 / PEAK_F32_FLOPS
                   * 1e12,
                   matmul_tflops=flops / rec["library_ms"] / 1e9)
        out.append(rec)
        del a, b, la, lb, got, again, want
    return out


#: gemm.cuh at the pair's record case (b 32, t 256, d_model 512, 8 heads):
#: (name, M, N, K, a given transposed, b given transposed, split), the
#: operand layouts of qkv_attention_bwd.cu's products and whether it splits
#: them over K (its dW products only)
GEMM_CASES = (("dx = dqkv w_qkv^T", 8192, 512, 1536, False, True, False),
              ("dW_qkv = x^T dqkv", 512, 1536, 8192, True, False, True),
              ("q|k|v = x w_qkv", 8192, 1536, 512, False, False, False))
#: the amp step's products on gemm.cuh's tensor-core tile in the element
#: types of the bf16 kernels (amp), the pair's five and #1's y: (name, M,
#: N, K, a transposed, b transposed, split, a bf16, b bf16, c bf16), an
#: f32 operand as hi/lo bf16 planes (``kernels.gemm.hi_lo``), each held
#: against ``reference_gemm`` (f32 arithmetic on the same operands) and
#: timed beside ``torch.matmul`` of the operands in bf16 (the planes' hi)
GEMM_AMP_CASES = (
    ("bf16 q|k|v = x w_qkv (bf16 x bf16 -> f32)", 8192, 1536, 512, False,
     False, False, True, True, False),
    ("bf16 dctx = g w_out^T (bf16 x bf16 -> f32)", 8192, 512, 512, False,
     True, False, True, True, False),
    ("bf16 dx = dqkv w_qkv^T (f32 x bf16 -> bf16)", 8192, 512, 1536, False,
     True, False, False, True, True),
    ("bf16 dW_qkv = x^T dqkv (bf16 x f32 -> bf16)", 512, 1536, 8192, True,
     False, True, True, False, True),
    ("bf16 dW_out = ctx^T g (bf16 x bf16 -> bf16)", 512, 512, 8192, True,
     False, True, True, True, True),
    ("bf16 y = ctx W_out (bf16 x bf16 -> bf16)", 8192, 512, 512, False,
     False, True, True, True, True))
#: the pair's dW_qkv at BERT-base (b 128, t 128, d_model 768, 12 heads),
#: where C13's slab depth decides the sum's error
GEMM_BERT_DW = ("BERT dW_qkv = x^T dqkv", 768, 2304, 16384, True, False,
                True)


def check_qkv_training(gen):
    """#1 in residual mode (y, ctx, lse), #2 and #3 alone and the pair #2
    + #3 (``qkv_bwd``, the autograd backward's one call) against their
    plain twins on QKV_CASES (the backward kernels from the forward
    kernel's residuals), at rates 0 and DROPOUT, each called twice on the
    same inputs for equal bits; a masked row must give ctx 0, lse +inf,
    zero dx_q, and in the pair #3's dx_kv bit for bit.  Then each timed
    beside its twin and the library yardstick: the no-grad forward of one
    ``F.multi_head_attention_forward`` for #1, its backward (dx, dW_in,
    dW_out together: the whole of #2 + #3's work) for #2, #3 and the pair.
    Returns {(kernel, case): record}; the pair's record at BERT-base's
    self-attention (``check_qkv_pair_bert``) under ("qkv_bwd", its
    case)."""
    from paddle_tpu_torch.kernels import attention as ka

    b, h, dh, dm = (TRAIN_BATCH, BASE["n_head"], BASE["d_key"],
                    BASE["d_model"])
    hd = h * dh
    out = {}
    for name, t, bias_kind, causal in QKV_CASES:
        x, w_qkv, w_out, g, bias = _qkv_inputs(gen, t, bias_kind)
        kw = dict(n_head=h, scale=dh ** -0.5, causal=causal)
        fw = (x, w_qkv, w_out, bias)
        (y, ctx, lse), (want_y, _, want_lse), hidden, err_fwd = \
            _held_qkv_fwd(f"qkv_attention_fwd {name}", fw, kw,
                          bias_kind == "masked")
        rows = hidden.transpose(1, 2)  # [b, t, h]

        bw = (x, w_qkv, w_out, bias, g, ctx, lse)
        got_dq, got_dkv = ka.qkv_bwd_dq(*bw, **kw), ka.qkv_bwd_dkv(*bw, **kw)
        want_dq = ka.reference_qkv_bwd_dq(*bw, **kw)
        want_dkv = ka.reference_qkv_bwd_dkv(*bw, **kw)
        again = ka.qkv_bwd_dq(*bw, **kw) + ka.qkv_bwd_dkv(*bw, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip(got_dq + got_dkv,
                                                      again)),
                f"qkv_bwd {name}: two calls on the same inputs differ")
        errs = []
        for kernel, parts, got, want in (
                ("qkv_bwd_dq", ("dx_q", "dW_q", "dW_out"), got_dq, want_dq),
                ("qkv_bwd_dkv", ("dx_kv", "dW_k", "dW_v"), got_dkv,
                 want_dkv)):
            errs.append(max(compare(f"{kernel} {name} {part}", a, w,
                                    TOL_KERNEL)
                            for part, a, w in zip(parts, got, want)))
        require(not got_dq[0][rows.any(-1)].any().item(),
                f"qkv_bwd_dq {name}: a masked row's dx_q is not 0")
        err_pair = _held_qkv_pair(f"qkv_bwd {name}", bw, kw, rows.any(-1),
                                  got_dkv[0])
        del got_dq, got_dkv, again

        lib_y, lib_fwd, lib_bwd = _library_mha(x, w_qkv, w_out, bias, g, h,
                                               causal)
        live = ~rows.any(-1)
        lib_err = (lib_y[live] - want_y[live]).abs().max().item()
        pairs = _visible_pairs(t, t, causal)
        proj = 2 * b * t * dm * hd  # one projection-sized product
        attn = 2 * b * h * pairs * dh  # one t x t product of every head
        io = F32 * (b * t * hd + b * h * t + dm * 3 * hd + hd * dm
                    + (bias.numel() if bias is not None else 0))
        act = F32 * b * t * dm  # one [b, t, d_model] tensor
        src = "paddle_tpu_torch/csrc/qkv_attention_bwd.cu"
        out[("qkv_attention_fwd", name)] = timed_record(
            "qkv_attention_fwd", "paddle_tpu_torch/csrc/qkv_attention.cu",
            "paddle_tpu/kernels/attention.py:1377", err_fwd,
            lambda: ka.qkv_attention_fwd(*fw, **kw),
            lambda: ka.reference_qkv_fwd(*fw, **kw), 4 * proj + 2 * attn,
            2 * act + io, lib_fwd, b)
        out[("qkv_attention_fwd", name)].update(
            library_max_abs_err=lib_err,
            plan=list(ka.qkv_fwd_plan(b, t, h, ka.sm_count(x.device))))
        out[("qkv_bwd_dq", name)] = timed_record(
            "qkv_bwd_dq", src, "paddle_tpu/kernels/attention.py:1454",
            errs[0], lambda: ka.qkv_bwd_dq(*bw, **kw),
            lambda: ka.reference_qkv_bwd_dq(*bw, **kw),
            7 * proj + 3 * attn, 3 * act + io + F32 * 2 * dm * hd, lib_bwd,
            b)
        out[("qkv_bwd_dkv", name)] = timed_record(
            "qkv_bwd_dkv", src, "paddle_tpu/kernels/attention.py:1546",
            errs[1], lambda: ka.qkv_bwd_dkv(*bw, **kw),
            lambda: ka.reference_qkv_bwd_dkv(*bw, **kw),
            8 * proj + 4 * attn, 3 * act + io + F32 * 2 * dm * hd, lib_bwd,
            b)
        out[("qkv_bwd", name)] = timed_record(
            "qkv_bwd", src, "paddle_tpu/kernels/attention.py:1454 + :1546",
            err_pair, lambda: ka.qkv_bwd(*bw, **kw),
            lambda: ka.reference_qkv_bwd(*bw, **kw),
            _qkv_pair_flops(proj, attn),
            _qkv_bwd_bytes(b, t, dm, h, bias), lib_bwd, b)
        del lib_fwd, lib_bwd

        # weights dropout at DROPOUT under one seed: #1's residuals, then
        # #2 and #3 from them (twice, for equal bits), each timed
        dkw = dict(kw, dropout_rate=DROPOUT, dropout_seed=int(
            torch.randint(0, 2 ** 32, (1,), generator=gen)))
        y_d, ctx_d, lse_d = ka.qkv_attention_fwd(*fw, **dkw)
        want_yd, want_ctxd, _ = ka.reference_qkv_fwd(*fw, **dkw)
        torch.cuda.synchronize()
        require(not torch.allclose(y_d, y, atol=1e-3),
                f"qkv_attention_fwd {name}: dropout changed nothing")
        errs = [max(compare(f"qkv_attention_fwd {name} dropout y", y_d,
                            want_yd, TOL_KERNEL),
                    compare(f"qkv_attention_fwd {name} dropout ctx", ctx_d,
                            want_ctxd, TOL_KERNEL))]
        errs[0] = max(errs[0], compare(
            f"qkv_attention_fwd {name} dropout lse", lse_d[~hidden],
            want_lse[~hidden], TOL_KERNEL))
        bw_d = (x, w_qkv, w_out, bias, g, ctx_d, lse_d)
        got_d = ka.qkv_bwd_dq(*bw_d, **dkw) + ka.qkv_bwd_dkv(*bw_d, **dkw)
        again = ka.qkv_bwd_dq(*bw_d, **dkw) + ka.qkv_bwd_dkv(*bw_d, **dkw)
        want_d = (ka.reference_qkv_bwd_dq(*bw_d, **dkw)
                  + ka.reference_qkv_bwd_dkv(*bw_d, **dkw))
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip(got_d, again)),
                f"qkv_bwd {name} dropout: two calls differ")
        parts = ("dx_q", "dW_q", "dW_out", "dx_kv", "dW_k", "dW_v")
        cmp = [compare(f"qkv_bwd {name} dropout {part}", a, w, TOL_KERNEL)
               for part, a, w in zip(parts, got_d, want_d)]
        errs += [max(cmp[:3]), max(cmp[3:])]
        errs.append(_held_qkv_pair(f"qkv_bwd {name} dropout", bw_d, dkw,
                                   rows.any(-1), got_d[3]))
        del got_d, again, want_d
        hashes = ATTN_HASH_OPS * b * h * pairs
        for kernel, err, fn, flops, nbytes in (
                ("qkv_attention_fwd", errs[0],
                 lambda: ka.qkv_attention_fwd(*fw, **dkw),
                 4 * proj + 2 * attn, 2 * act + io),
                ("qkv_bwd_dq", errs[1], lambda: ka.qkv_bwd_dq(*bw_d, **dkw),
                 7 * proj + 3 * attn, 3 * act + io + F32 * 2 * dm * hd),
                ("qkv_bwd_dkv", errs[2],
                 lambda: ka.qkv_bwd_dkv(*bw_d, **dkw), 8 * proj + 4 * attn,
                 3 * act + io + F32 * 2 * dm * hd),
                ("qkv_bwd", errs[3], lambda: ka.qkv_bwd(*bw_d, **dkw),
                 _qkv_pair_flops(proj, attn),
                 _qkv_bwd_bytes(b, t, dm, h, bias))):
            out[(kernel, name)].update(
                dropout_max_abs_err=err, dropout_ms=cuda_ms(fn),
                dropout_bound_ms=bound(flops, nbytes, hashes)[0])
    out[("qkv_bwd", QKV_PAIR_BERT[0])] = check_qkv_pair_bert(gen)
    return out


#: phase 2's cases of #1's routes (``kernels.attention.qkv_fwd_plan``):
#: (name, b, t, d_model, bias, causal), heads of 64, each run at rates 0
#: and DROPOUT.  Between them they reach a one-block cluster (t 8), BERT-
#: base's self-attention (C 2), a ragged last block of 8 rows in 32 (t
#: 200, R 32, C 7), the b=1 prefill's 32-row blocks (C 8), the b=64
#: decoder (C 4, R 64), the largest cluster (t 512: C 8, R 64) and the
#: long-sequence "tiles" route (t 640); b stays small at t 512 and 640.
QKV_PLAN_CASES = (("t 8", 4, 8, 512, "pad", False),
                  ("bert self", 128, 128, 768, "pad", False),
                  ("ragged t 200, -1e30 row", 4, 200, 512, "masked", False),
                  ("b 1 t 256 causal", 1, 256, 512, None, True),
                  ("b 64 decoder", 64, 256, 512, "decoder", False),
                  ("t 512 causal, -1e30 row", 2, 512, 512, "masked", True),
                  ("tiles t 640", 2, 640, 512, "pad", False))


def check_qkv_plans(gen):
    """#1 in residual mode on every route of ``qkv_fwd_plan``
    (QKV_PLAN_CASES): y, ctx and lse against the twin within TOL_KERNEL at
    rates 0 and DROPOUT, each call repeated for equal bits, masked rows
    with ctx 0 and lse +inf; each case timed beside its twin and one
    ``F.multi_head_attention_forward``.  Returns {case: record}, each with
    its plan; the cluster occupancy (``cudaOccupancyMaxActiveClusters``)
    of 8-block clusters at R = 32 and 64 is printed."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import attention as ka

    lib = _build.lib()
    for dh in (64, 128):
        for rows in (32, 64):
            n = lib.ptt_qkv_cluster_occupancy(rows, ka.CLUSTER_MAX, dh)
            require(n > 0, f"qkv cluster occupancy R={rows} dh={dh}: {n}")
            print(f"phase 2: qkv_attention_fwd clusters of "
                  f"{ka.CLUSTER_MAX} blocks of {rows} rows at head width "
                  f"{dh} resident at once: {n}")
    out = {}
    for name, b, t, dm, bias_kind, causal in QKV_PLAN_CASES:
        h, dh = dm // 64, 64
        x, w_qkv, w_out, g, bias = _qkv_inputs(gen, t, bias_kind, b, dm)
        plan = ka.qkv_fwd_plan(b, t, h, ka.sm_count(x.device))
        fw = (x, w_qkv, w_out, bias)
        errs = {}
        for rate in (0.0, DROPOUT):
            kw = dict(n_head=h, scale=dh ** -0.5, causal=causal,
                      dropout_rate=rate, dropout_seed=int(torch.randint(
                          0, 2 ** 32, (1,), generator=gen)))
            errs[rate] = _held_qkv_fwd(
                f"qkv_attention_fwd {name} rate {rate}", fw, kw,
                bias_kind == "masked")[3]
        _, lib_fwd, _ = _library_mha(x, w_qkv, w_out, bias, g, h, causal)
        pairs = _visible_pairs(t, t, causal)
        proj = 2 * b * t * dm * dm
        attn = 2 * b * h * pairs * dh
        io = F32 * (b * t * dm + b * h * t + dm * 3 * dm + dm * dm
                    + (bias.numel() if bias is not None else 0))
        kw = dict(n_head=h, scale=dh ** -0.5, causal=causal)
        rec = timed_record(
            "qkv_attention_fwd", "paddle_tpu_torch/csrc/qkv_attention.cu",
            "paddle_tpu/kernels/attention.py:1377", errs[0.0],
            lambda: ka.qkv_attention_fwd(*fw, **kw),
            lambda: ka.reference_qkv_fwd(*fw, **kw), 4 * proj + 2 * attn,
            2 * F32 * b * t * dm + io, lib_fwd, b)
        dkw = dict(kw, dropout_rate=DROPOUT, dropout_seed=1)
        # at t 8 the call is shorter than the host's enqueue of it: ms
        # counts the host, device_ms hides it
        rec.update(plan=list(plan), t=t, d_model=dm, causal=causal,
                   bias=bias_kind, dropout_max_abs_err=errs[DROPOUT],
                   device_ms=cuda_ms(lambda: ka.qkv_attention_fwd(*fw, **kw),
                                     hide_host=True),
                   dropout_ms=cuda_ms(
                       lambda: ka.qkv_attention_fwd(*fw, **dkw)),
                   dropout_bound_ms=bound(
                       4 * proj + 2 * attn, 2 * F32 * b * t * dm + io,
                       ATTN_HASH_OPS * b * h * pairs)[0])
        out[name] = rec
        del lib_fwd, x, w_qkv, w_out, g, bias
    return out


#: phase 2's head-width shape of the route checks (C2): b, t, heads
HEAD128 = (2, 64, 2)


def check_head_width_128(gen):
    """C2 on the card, by kernel, dtype and head width (``kernels.
    HEAD_WIDTHS``).  At 128 every attention and decode wrapper launches
    its head-width-128 instantiation, each kernel counted once under its
    ``_dh128`` name (``_bf16_dh128`` in bf16) and nothing else: the
    serving path's f32 kernels (``flash_qkv_attention`` with no gradient,
    #1; ``flash_decode`` and ``flash_decode_paged``, #14, #15;
    ``fused_decode_step`` and ``fused_decode_step_paged``, #10 + #11, #12
    + #13), the f32 training kernels (``flash_qkv_attention`` with a
    gradient, forward and backward: #1 and the pair #2 + #3; the pair
    ``qkv_bwd`` itself; ``flash_attention`` forward and backward in both
    layouts: #4, #6, #7; #5, #8, #9) and the same training kernels in
    bf16.  At 192, where no kernel is compiled, every one of those
    wrappers raises a ValueError naming the kernel and the width before
    anything launches or composes, and so does every (kernel, dtype) of
    the route table (``head_route``).  Returns {call: launches or the
    error}."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import attention as ka
    from paddle_tpu_torch.kernels import decode_attention as kda
    from paddle_tpu_torch.kernels import decode_step as kds

    b, t, h = HEAD128

    def qkv(dh, dtype=torch.float32, grad=False):
        dm = h * dh
        x = randn(gen, b, t, dm).to(dtype).requires_grad_(grad)
        w_qkv = randn(gen, dm, 3 * dm, scale=dm ** -0.5).to(dtype)
        w_out = randn(gen, dm, dm, scale=dm ** -0.5).to(dtype)
        g = randn(gen, b, t, dm).to(dtype)

        def call():
            y = ka.flash_qkv_attention(x, w_qkv, w_out, n_head=h,
                                       scale=dh ** -0.5)
            if grad:
                y.backward(g)
        return call

    def pair(dh):
        dm = h * dh
        x, g = randn(gen, b, t, dm), randn(gen, b, t, dm)
        w_qkv = randn(gen, dm, 3 * dm, scale=dm ** -0.5)
        w_out = randn(gen, dm, dm, scale=dm ** -0.5)
        ctx, lse = randn(gen, b, t, h, dh), randn(gen, b, h, t)
        return lambda: ka.qkv_bwd(x, w_qkv, w_out, None, g, ctx, lse,
                                  n_head=h, scale=dh ** -0.5)

    def flash(dh, fmt, dtype=torch.float32, grad=False):
        q = randn(gen, b, t, h, dh).to(dtype).requires_grad_(grad)

        def call():
            o = ka.flash_attention(q, q, q, scale=dh ** -0.5, fmt=fmt)
            if grad:
                o.backward(torch.ones_like(o))
        return call

    def decode(dh, paged):
        q = randn(gen, b, h, dh)
        k, v = randn(gen, b, 32, h, dh), randn(gen, b, 32, h, dh)
        lens = torch.tensor([5, 32], dtype=torch.int32).cuda()
        if not paged:
            return lambda: kda.flash_decode(q, k, v, lens, dh ** -0.5)
        table = torch.arange(2 * b, dtype=torch.int32).reshape(b, 2).cuda()
        pool_k, pool_v = (a.reshape(2 * b, 16, h, dh) for a in (k, v))
        return lambda: kda.flash_decode_paged(q, pool_k, pool_v, table, lens,
                                              dh ** -0.5)

    def step(dh, paged):
        cfg = dict(BASE, n_head=h, d_key=dh, d_value=dh, d_model=128,
                   d_inner_hid=256, n_layer=2)
        x, w, ffn, caches, ints = (_paged_inputs if paged
                                   else _decode_inputs)(gen, b, cfg=cfg)
        fn = kds.fused_decode_step_paged if paged else kds.fused_decode_step
        return lambda: fn(x, **w, **ffn, **caches, **ints, layer=1,
                          n_head=h, scale=dh ** -0.5)

    bf16 = torch.bfloat16
    # (make(dh), the launches at 128, under no_grad)
    launching = {
        "flash_qkv_attention no grad": (qkv, {"qkv_attention_fwd": 1},
                                        True),
        "flash_decode": (lambda dh: decode(dh, False), {"flash_decode": 1},
                         True),
        "flash_decode_paged": (lambda dh: decode(dh, True),
                               {"flash_decode_paged": 1}, True),
        "fused_decode_step": (lambda dh: step(dh, False),
                              {"megastep": 1, "ffn": 1}, True),
        "fused_decode_step_paged": (lambda dh: step(dh, True),
                                    {"megastep_paged": 1, "ffn": 1}, True),
        "flash_qkv_attention with grad": (
            lambda dh: qkv(dh, grad=True),
            {"qkv_attention_fwd": 1, "qkv_bwd_dq": 1, "qkv_bwd_dkv": 1},
            False),
        "qkv_bwd f32": (pair, {"qkv_bwd_dq": 1, "qkv_bwd_dkv": 1}, False),
        "flash_attention bthd with grad": (
            lambda dh: flash(dh, "bthd", grad=True),
            {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}, False),
        "flash_attention bhtd with grad": (
            lambda dh: flash(dh, "bhtd", grad=True),
            {"flash_fwd_bhtd": 1, "flash_bwd_dq_bhtd": 1,
             "flash_bwd_dkv_bhtd": 1}, False),
        "flash_qkv_attention bf16 no grad": (
            lambda dh: qkv(dh, bf16), {"qkv_attention_fwd_bf16": 1}, True),
        "flash_qkv_attention bf16 with grad": (
            lambda dh: qkv(dh, bf16, grad=True),
            {"qkv_attention_fwd_bf16": 1, "qkv_bwd_dq_bf16": 1,
             "qkv_bwd_dkv_bf16": 1}, False),
        "flash_attention bthd bf16 with grad": (
            lambda dh: flash(dh, "bthd", bf16, grad=True),
            {"flash_fwd_bf16": 1, "flash_bwd_dq_bf16": 1,
             "flash_bwd_dkv_bf16": 1}, False),
        "flash_attention bhtd bf16 with grad": (
            lambda dh: flash(dh, "bhtd", bf16, grad=True),
            {"flash_fwd_bhtd_bf16": 1, "flash_bwd_dq_bhtd_bf16": 1,
             "flash_bwd_dkv_bhtd_bf16": 1}, False)}
    out = {}

    def raises(label, call, dh):
        kernels.reset_launches()
        try:
            call()
        except ValueError as exc:
            out[label] = str(exc)
        torch.cuda.synchronize()
        require(label in out and f"head width {dh}" in out[label],
                f"{label}: no error ({out.get(label)})")
        launches, composed = dict(kernels.launches), dict(kernels.composed)
        require(launches == expected(), f"{label}: launched {launches}")
        require(not any(composed.values()),
                f"{label}: composition counts {composed}")

    for what, (make, counts, no_grad) in launching.items():
        call = make(128)
        kernels.reset_launches()
        with torch.set_grad_enabled(not no_grad):
            call()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        require(launches == expected(**{
            name + ("" if name == "ffn" else "_dh128"): n
            for name, n in counts.items()}),
            f"head width 128 {what}: launches {launches}")
        require(not any(kernels.composed.values()),
                f"head width 128 {what}: composed {kernels.composed}")
        out[f"{what} at 128"] = {k: v for k, v in launches.items() if v}
        raises(f"{what} at 192", make(192), 192)
    for name in kernels.composed:
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and name not in kernels.BF16_KERNELS:
                continue
            try:
                kernels.head_route(name, 192, dtype)
                require(False, f"{name} {dtype}: routes at head width 192")
            except ValueError as exc:
                require(name in str(exc) and "head width 192" in str(exc),
                        f"{name} {dtype} at 192: {exc}")
    out["every kernel and dtype at 192"] = "raises"
    kernels.reset_launches()
    return out


#: phase 2's dropout-add shape: the training step's residual sites at
#: batch 32, length 256, d_model 512
DROPOUT_ROWS = 32 * 256
#: chi-square (1 degree of freedom) bound on the keep count of #16's
#: pattern check: exceeded with probability 0.001 by a fair coin of 0.9
CHI2_BOUND = 10.83


def check_dropout_add(gen):
    """#16 and #17 at [32*256, 512] f32 against their plain twins: the
    keep pattern of x = 1, residual = 0 exactly (and its keep share within
    CHI2_BOUND of 0.9), #16 on random x and residual within TOL_KERNEL,
    #16 without a residual (the embedding sites) and #17 bit for bit;
    timed with and without the host's enqueue, and beside the parent's
    kernels with ``--parent``.  Returns (#16's record, #17's record)."""
    from paddle_tpu_torch.kernels import dropout_epilogue as kde
    from paddle_tpu_torch.kernels import hash_rng

    shape = (DROPOUT_ROWS, BASE["d_model"])
    n = DROPOUT_ROWS * BASE["d_model"]
    seed = int(torch.randint(0, 2 ** 32, (1,), generator=gen))
    ones, zeros = torch.ones(shape).cuda(), torch.zeros(shape).cuda()
    pattern = kde.dropout_add_fwd(ones, zeros, DROPOUT, seed)
    want = kde.reference_dropout_add(ones, zeros, DROPOUT, seed)
    torch.cuda.synchronize()
    require(torch.equal(pattern, want),
            "dropout_add_fwd: keep pattern differs from the twin's")
    kept = int((pattern != 0).sum().item())
    p = 1 - DROPOUT
    chi2 = (kept - n * p) ** 2 / (n * p * (1 - p))
    require(chi2 <= CHI2_BOUND, f"dropout_add_fwd: kept {kept} of {n} "
            f"(chi-square {chi2:.2f} over {CHI2_BOUND})")
    require(torch.equal(pattern != 0, hash_rng.keep_mask(
        seed, shape, DROPOUT, device=pattern.device)),
            "dropout_add_fwd: keep pattern is not keep_mask's")

    x, res, g = (randn(gen, *shape) for _ in range(3))
    got = kde.dropout_add_fwd(x, res, DROPOUT, seed)
    want = kde.reference_dropout_add(x, res, DROPOUT, seed)
    plain_drop = kde.dropout_add_fwd(x, None, DROPOUT, seed)
    dx = kde.dropout_add_bwd(g, DROPOUT, seed)
    torch.cuda.synchronize()
    err = max(compare("dropout_add_fwd", got, want, TOL_KERNEL),
              compare("dropout_add_fwd no residual", plain_drop,
                      kde.reference_dropout_add(x, None, DROPOUT, seed),
                      TOL_KERNEL))
    want_dx = kde.reference_dropout_add_bwd(g, DROPOUT, seed)
    require(torch.equal(dx, want_dx), "dropout_add_bwd: differs from twin")
    src = "paddle_tpu_torch/csrc/dropout_add.cu"
    fwd = timed_record(
        "dropout_add_fwd", src, "paddle_tpu/kernels/dropout_epilogue.py:62",
        err, lambda: kde.dropout_add_fwd(x, res, DROPOUT, seed),
        lambda: kde.reference_dropout_add(x, res, DROPOUT, seed), 0,
        3 * F32 * n, None, TRAIN_BATCH, int_ops=HASH_OPS * n)
    tensor_core_times(fwd, lambda: kde.dropout_add_fwd(x, res, DROPOUT,
                                                       seed))

    def plain_fn():
        return kde.dropout_add_fwd(x, None, DROPOUT, seed)

    fwd.update(keep_share=kept / n, keep_chi2=chi2,
               no_residual_ms=cuda_ms(plain_fn),
               no_residual_device_ms=cuda_ms(plain_fn, hide_host=True),
               no_residual_parent_device_ms=parent_ms(plain_fn,
                                                      hide_host=True),
               no_residual_bound_ms=bound(0, 2 * F32 * n,
                                          HASH_OPS * n)[0])
    bwd = timed_record(
        "dropout_add_bwd", src, "paddle_tpu/kernels/dropout_epilogue.py:76",
        0.0, lambda: kde.dropout_add_bwd(g, DROPOUT, seed),
        lambda: kde.reference_dropout_add_bwd(g, DROPOUT, seed), 0,
        2 * F32 * n, None, TRAIN_BATCH, int_ops=HASH_OPS * n)
    tensor_core_times(bwd, lambda: kde.dropout_add_bwd(g, DROPOUT, seed))
    return fwd, bwd


#: bf16 (amp) kernels against their bf16 twins on the card: the same bf16
#: operands, f32 arithmetic in other orders, each output rounded to bf16
#: (8 significant bits), so one bf16 step apart at most, TOL_BF16 = 2^-7 of
#: the value, plus, where a sum cancels after an intermediate rounding
#: (#1's ctx before y), one step (2^-8) of the tensor's largest element;
#: lse and delta are f32 and held to TOL_KERNEL.  #16 and #17 in bf16 must
#: equal their twins bit for bit.
TOL_BF16 = 2.0 ** -7
#: the largest share of a tensor-core kernel's bf16 output (#4's o, #1's
#: ctx) that may differ from its float64 twin's value rounded to bf16.
#: compare_bf16 cannot tell whether p (and #1's q, k, v) keep their hi/lo
#: split: p rounded to one bf16 moves o by about 2^-9 a term, within its
#: bound.  That moves 36-38% of o and ctx off the rounded value, the split
#: 0.2-0.5% (H100, the amp step's shapes)
TOL_OFF_ROUNDING = 0.02
#: H100 SXM dense bf16 tensor-core FLOP/s: the least time the card could
#: take for a bf16 function's products (the bound of every bf16 record)
PEAK_BF16_FLOPS = 989e12
BF16 = 2


def compare_bf16(name, got, want, steps=1):
    """Max abs error; raises unless |got - want| <= steps * (TOL_BF16 *
    |want| + 2^-8 * max |want|)."""
    got, want = got.float(), want.float()
    require(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    err = (got - want).abs()
    scale = want.abs().max().item()
    worst = (err - steps * (TOL_BF16 * want.abs() + 2.0 ** -8 * scale)
             ).max().item()
    max_abs = err.max().item()
    require(worst <= 0, f"{name}: max abs err {max_abs} over {steps} bf16 "
            f"step(s) (largest magnitude {scale})")
    return max_abs


def off_rounding(name, got, exact):
    """The share of the bf16 ``got`` that is not the float64 ``exact``
    rounded to bf16; raises above TOL_OFF_ROUNDING."""
    share = (got != exact.to(got.dtype)).double().mean().item()
    require(share <= TOL_OFF_ROUNDING, f"{name}: {share:.2%} of the output "
            f"is off the float64 value rounded to bf16 (at most "
            f"{TOL_OFF_ROUNDING:.0%})")
    return share


def bound_bf16(flops, nbytes, int_ops=0):
    """(bound_ms, bound_by) of a bf16 function: bytes over the HBM rate
    against its FLOPs at the dense bf16 tensor-core rate (the int32 hash
    operations run on the CUDA cores beside them)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_BF16_FLOPS, int_ops / PEAK_INT32_OPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bf16(*tensors):
    return [None if a is None else a.bfloat16().contiguous()
            for a in tensors]


def _require_odd_bias_bits(what, fn, bias, kw):
    """fn(bias, kw) at rates 0 and DROPOUT gives the same bits on a copy of
    the bf16 ``bias`` (random values, so that a shifted read would show)
    whose data starts at an odd element (2 bytes past a 4-byte boundary,
    the strides unchanged): the tensor-core kernels load a bias pair as
    one 4-byte word only from a 4-byte aligned base, and read such a view
    element by element."""
    odd = torch.empty(bias.numel() + 1, dtype=bias.dtype,
                      device=bias.device)[1:].view(bias.shape)
    odd.copy_(bias)
    require(odd.data_ptr() % 4 == 2, f"{what}: the copy is not at an odd "
            "element")
    for rate in (0.0, DROPOUT):
        kw_ = dict(kw, dropout_rate=rate, dropout_seed=1234)
        _require_same_bits(f"{what} bias at an odd element rate {rate}",
                           fn(odd, kw_), fn(bias, kw_))
    print(f"phase 2: {what}: a bias at an odd element gives the aligned "
          f"bias's bits at rates 0 and {DROPOUT}")


#: the bthd kernels' bf16 cases: (name, tq, tk, bias, causal); the record
#: case is the amp step's cross-attention (decoder queries over the
#: encoder's keys under the source padding bias)
AMP_FLASH_CASES = (("cross tq 256 tk 256", 256, 256, "pad", False),
                   ("decoder self", 256, 256, "decoder", False),
                   ("causal tq>tk, -1e30 row", 256, 128, "masked", True),
                   ("ragged causal tq 129 tk 129", 129, 129, "decoder",
                    True))


def check_flash_attention_bf16(gen):
    """#4, #6 and #7 in bf16 (amp), all on tensor cores, against their
    bf16 twins on AMP_FLASH_CASES at rates 0 and DROPOUT, each called
    twice for equal bits, by ``compare_bf16``; a row masked in the forward
    (lse = +inf) gets dq = 0.  At the record case each is timed beside its
    twin, the parent's kernel (``tensor_core_times``) and masked
    ``F.scaled_dot_product_attention`` in bf16 (its backward for #6 and
    #7), with and without the host's enqueue, bounds at 2 bytes an element
    and the bf16 tensor-core rate, and the share of o, dq, dk and dv off
    the float64 value rounded to bf16 at most TOL_OFF_ROUNDING (the
    parent's share beside #6's and #7's).  A bias view at an odd element
    gives the aligned bias's bits in all three.  Returns {kernel name:
    record}."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import attention as ka

    b, h, dh = TRAIN_BATCH, BASE["n_head"], BASE["d_key"]
    scale = dh ** -0.5
    out = {}
    for case, tq, tk, bias_kind, causal in AMP_FLASH_CASES:
        q, k, v, do, bias = _bf16(*_flash_inputs(gen, tq, tk, bias_kind,
                                                 causal))
        errs = {}
        for rate in (0.0, DROPOUT):
            kw = dict(scale=scale, causal=causal, dropout_rate=rate,
                      dropout_seed=int(torch.randint(0, 2 ** 32, (1,),
                                                     generator=gen)))
            what = f"bf16 {case} rate {rate}"
            o, lse = ka.flash_fwd(q, k, v, bias, **kw)
            _require_same_bits(f"flash_fwd {what}", (o, lse),
                               ka.flash_fwd(q, k, v, bias, **kw))
            want_o, want_lse = ka.reference_flash_fwd(q, k, v, bias, **kw)
            hidden = torch.isinf(want_lse)
            require(o.dtype == torch.bfloat16 and torch.equal(
                hidden, torch.isinf(lse)), f"flash_fwd {what}: masked rows "
                "or dtype differ")
            err_f = max(compare_bf16(f"flash_fwd {what}", o, want_o),
                        compare(f"flash_fwd {what} lse", lse[~hidden],
                                want_lse[~hidden], TOL_KERNEL))
            delta = (do.float() * o.float()).sum(-1).transpose(
                1, 2).contiguous()
            bw = (q, k, v, bias, do, lse, delta)
            dq = ka.flash_bwd_dq(*bw, **kw)
            _require_same_bits(f"flash_bwd_dq {what}", (dq,),
                               (ka.flash_bwd_dq(*bw, **kw),))
            dk, dv = ka.flash_bwd_dkv(*bw, **kw)
            _require_same_bits(f"flash_bwd_dkv {what}", (dk, dv),
                               ka.flash_bwd_dkv(*bw, **kw))
            if bias_kind == "masked":
                # the row masked in the forward (lse = +inf) gets dq = 0
                require(torch.isinf(lse[-1, :, tq - 5]).all().item()
                        and not dq[-1, tq - 5].any().item(),
                        f"flash_bwd_dq {what}: the masked row's dq is not "
                        "0")
            want_dk, want_dv = ka.reference_flash_bwd_dkv(*bw, **kw)
            errs[rate] = (err_f, compare_bf16(
                f"flash_bwd_dq {what}", dq,
                ka.reference_flash_bwd_dq(*bw, **kw)),
                max(compare_bf16(f"flash_bwd_dkv {what} dk", dk, want_dk),
                    compare_bf16(f"flash_bwd_dkv {what} dv", dv, want_dv)))
            del want_dk, want_dv
            if rate == 0.0:
                bw0, kw0 = bw, kw
            else:
                bw_d, kw_d = bw, kw
        if case != AMP_FLASH_CASES[0][0]:
            continue
        off = off_rounding(f"flash_fwd bf16 {case}",
                           ka.flash_fwd(q, k, v, bias, **kw0)[0],
                           ka.reference_flash_fwd(*(a.double() for a in (
                               q, k, v, bias)), **kw0)[0])
        bw_off = _flash_bwd_off_rounding(bw0, kw0)
        mask = bias
        lq, lk, lv = (a.transpose(1, 2).detach().requires_grad_()
                      for a in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                                 scale=scale)
        lib_do = do.transpose(1, 2)

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    lq, lk, lv, attn_mask=mask, scale=scale)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (lq, lk, lv), lib_do,
                                       retain_graph=True)

        flops = b * h * _visible_pairs(tq, tk, causal) * dh
        rows, keys = BF16 * b * h * tq * dh, BF16 * b * h * tk * dh
        bias_bytes = BF16 * bias.numel()
        stats = F32 * 2 * b * h * tq
        hashes = ATTN_HASH_OPS * b * h * _visible_pairs(tq, tk, causal)
        src = "paddle_tpu_torch/csrc/flash_bwd_tc.cuh"
        # MMA FLOPs issued, in t x t products with the splits: #4 3 (s,
        # p v twice), the dq walk 4, the dkv walk 6; the functions' 2, 3
        # and 4 (``mult``)
        mma_mult = (6, 8, 12)
        for i, (kernel, line, fn, twin, mult, nbytes) in enumerate((
                ("flash_fwd", 550, ka.flash_fwd, ka.reference_flash_fwd, 4,
                 2 * rows + 2 * keys + bias_bytes + stats // 2),
                ("flash_bwd_dq", 618, ka.flash_bwd_dq,
                 ka.reference_flash_bwd_dq, 6,
                 3 * rows + 2 * keys + bias_bytes + stats),
                ("flash_bwd_dkv", 678, ka.flash_bwd_dkv,
                 ka.reference_flash_bwd_dkv, 8,
                 2 * rows + 4 * keys + bias_bytes + stats))):
            args, args_d = ((q, k, v, bias), (q, k, v, bias)) if i == 0 \
                else (bw0, bw_d)
            rec = timed_record(
                kernel + "_bf16",
                "paddle_tpu_torch/csrc/flash_tc.cuh" if i == 0 else src,
                f"paddle_tpu/kernels/attention.py:{line}", errs[0.0][i],
                lambda: fn(*args, **kw0), lambda: twin(*args, **kw0),
                mult * flops, nbytes, lib_fwd if i == 0 else lib_bwd, b,
                bound_fn=bound_bf16)
            rec.update(case=case, dtype="bf16",
                       dropout_max_abs_err=errs[DROPOUT][i],
                       dropout_ms=cuda_ms(lambda: fn(*args_d, **kw_d)),
                       dropout_bound_ms=bound_bf16(mult * flops, nbytes,
                                                   hashes)[0],
                       mma_flops=mma_mult[i] * flops)
            # the parent's kernel (#4: tensor cores; #6, #7: the CUDA
            # cores), same inputs
            tensor_core_times(rec, lambda: fn(*args, **kw0),
                              lambda: fn(*args_d, **kw_d),
                              lib_fwd if i == 0 else lib_bwd)
            rec["off_rounding_share"] = off if i == 0 else bw_off[kernel]
            out[kernel + "_bf16"] = rec
        del lib_out
    odd_gen = torch.Generator().manual_seed(4)
    q, k, v, _, bias = _flash_inputs(odd_gen, 256, 256, "decoder", False)
    q, k, v, bias = _bf16(q, k, v, bias + randn(odd_gen, *bias.shape))
    _require_odd_bias_bits("flash_fwd bf16 decoder self",
                           lambda bias_, kw: ka.flash_fwd(q, k, v, bias_,
                                                          **kw),
                           bias, dict(scale=scale, causal=False))
    do = randn(odd_gen, *q.shape).bfloat16()
    o, lse = ka.flash_fwd(q, k, v, bias, scale=scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    _require_odd_bias_bits("flash_bwd_dq bf16 decoder self",
                           lambda bias_, kw: (ka.flash_bwd_dq(
                               q, k, v, bias_, do, lse, delta, **kw),),
                           bias, dict(scale=scale, causal=False))
    _require_odd_bias_bits("flash_bwd_dkv bf16 decoder self",
                           lambda bias_, kw: ka.flash_bwd_dkv(
                               q, k, v, bias_, do, lse, delta, **kw),
                           bias, dict(scale=scale, causal=False))
    return out


def _flash_bwd_off_rounding(bw, kw, suffix=""):
    """The layout's dq walk's dq and dkv walk's dk, dv in bf16 (#6, #7; #8,
    #9 with ``suffix`` "_bhtd") off the float64 twin's value rounded to
    bf16: {"flash_bwd_dq" + suffix: ``_off_rounding_shares``,
    "flash_bwd_dkv" + suffix: ...}.  The parent's shares (``--parent``)
    only for the bthd kernels, which the parent has in bf16."""
    from paddle_tpu_torch.kernels import attention as ka

    b64 = [None if a is None else a.double() for a in bw]
    dq, dkv = (getattr(ka, name + suffix)
               for name in ("flash_bwd_dq", "flash_bwd_dkv"))
    dq64, dkv64 = (getattr(ka, "reference_" + name + suffix)
                   for name in ("flash_bwd_dq", "flash_bwd_dkv"))
    return {"flash_bwd_dq" + suffix: _off_rounding_shares(
                "flash_bwd_dq" + suffix + " bf16", ("dq",),
                lambda: (dq(*bw, **kw),), (dq64(*b64, **kw),),
                not suffix),
            "flash_bwd_dkv" + suffix: _off_rounding_shares(
                "flash_bwd_dkv" + suffix + " bf16", ("dk", "dv"),
                lambda: dkv(*bw, **kw), dkv64(*b64, **kw), not suffix)}


#: phase 2's bf16 bhtd cases (#5, #8, #9 in bf16: amp's attention_fuse
#: route) at BERT-base's self-attention, q, k, v [128, 12, t, 64] bf16:
#: (name, tq, tk, bias, causal) as in BHTD_CASES; every case's outputs
#: must also be the bthd bf16 kernels' (#4, #6, #7) bits on the transposed
#: tensors, which holds those at BERT-base's shapes too
BHTD_BF16_CASES = (("bert self", 128, 128, "pad", False),
                   ("causal", 128, 128, "pad", True),
                   ("causal tq>tk, -1e30 row", 128, 64, "masked", True),
                   ("cross tq 64 tk 128", 64, 128, "pad", False),
                   ("ragged tq 72 tk 200", 72, 200, "pad", False),
                   ("ragged causal tq 200 tk 136", 200, 136, "pad", True))


def check_flash_attention_bhtd_bf16(gen):
    """#5, #8 and #9 in bf16 (amp), on tensor cores, against their bf16
    twins on BHTD_BF16_CASES at rates 0 and DROPOUT, each called twice for
    equal bits, by ``compare_bf16``; each output must equal the bthd bf16
    kernel's on the transposed tensors bit for bit (the same kernels on
    another row layout, the same mask); a row masked in the forward gets
    dq = 0.  At BHTD_RECORD_CASE each is timed beside its twin and masked
    ``F.scaled_dot_product_attention`` in bf16 on the same [b, h, t, 64]
    tensors (its backward for #8 and #9), with and without the host's
    enqueue, bounds at 2 bytes an element and the bf16 tensor-core rate,
    and the share of o, dq, dk and dv off the float64 value rounded to
    bf16 at most TOL_OFF_ROUNDING.  A bias view at an odd element gives
    the aligned bias's bits in all three.  Returns {kernel name:
    record}."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import attention as ka

    b, h, dh = BERT_BATCH, BERT["n_head"], 64
    scale = dh ** -0.5
    out = {}
    t_ = ka._bthd  # [b, h, t, d] <-> [b, t, h, d] (a view)
    for case, tq, tk, bias_kind, causal in BHTD_BF16_CASES:
        q, k, v, do, bias = _bf16(*_bhtd_inputs(gen, tq, tk, bias_kind))
        qt, kt, vt, dot = (t_(a).contiguous() for a in (q, k, v, do))
        errs = {}
        for rate in (0.0, DROPOUT):
            kw = dict(scale=scale, causal=causal, dropout_rate=rate,
                      dropout_seed=int(torch.randint(0, 2 ** 32, (1,),
                                                     generator=gen)))
            what = f"bf16 {case} rate {rate}"
            o, lse = ka.flash_fwd_bhtd(q, k, v, bias, **kw)
            _require_same_bits(f"flash_fwd_bhtd {what}", (o, lse),
                               ka.flash_fwd_bhtd(q, k, v, bias, **kw))
            o_t, lse_t = ka.flash_fwd(qt, kt, vt, bias, **kw)
            require(torch.equal(o, t_(o_t)) and torch.equal(lse, lse_t),
                    f"flash_fwd_bhtd {what}: not flash_fwd's bits on the "
                    "transposed tensors")
            want_o, want_lse = ka.reference_flash_fwd_bhtd(q, k, v, bias,
                                                           **kw)
            hidden = torch.isinf(want_lse)
            require(o.dtype == torch.bfloat16 and torch.equal(
                hidden, torch.isinf(lse)), f"flash_fwd_bhtd {what}: masked "
                "rows or dtype differ")
            require(bool(hidden.any()) == (causal and tq > tk),
                    f"flash_fwd_bhtd {what}: {int(hidden.sum())} masked "
                    "rows")
            err_f = max(compare_bf16(f"flash_fwd_bhtd {what}", o, want_o),
                        compare(f"flash_fwd_bhtd {what} lse", lse[~hidden],
                                want_lse[~hidden], TOL_KERNEL))
            del want_o, o_t
            delta = (do.float() * o.float()).sum(-1).contiguous()
            bw = (q, k, v, bias, do, lse, delta)
            dq = ka.flash_bwd_dq_bhtd(*bw, **kw)
            _require_same_bits(f"flash_bwd_dq_bhtd {what}", (dq,),
                               (ka.flash_bwd_dq_bhtd(*bw, **kw),))
            dk, dv = ka.flash_bwd_dkv_bhtd(*bw, **kw)
            _require_same_bits(f"flash_bwd_dkv_bhtd {what}", (dk, dv),
                               ka.flash_bwd_dkv_bhtd(*bw, **kw))
            bw_t = (qt, kt, vt, bias, dot, lse, delta)
            dk_t, dv_t = ka.flash_bwd_dkv(*bw_t, **kw)
            require(torch.equal(dq, t_(ka.flash_bwd_dq(*bw_t, **kw)))
                    and torch.equal(dk, t_(dk_t))
                    and torch.equal(dv, t_(dv_t)),
                    f"flash_bwd_*_bhtd {what}: not the bthd walks' bits on "
                    "the transposed tensors")
            del dk_t, dv_t
            if bias_kind == "masked":
                # the row masked in the forward (lse = +inf) gets dq = 0
                require(torch.isinf(lse[-1, :, tq - 5]).all().item()
                        and not dq[-1, :, tq - 5].any().item(),
                        f"flash_bwd_dq_bhtd {what}: the masked row's dq is "
                        "not 0")
            want_dk, want_dv = ka.reference_flash_bwd_dkv_bhtd(*bw, **kw)
            errs[rate] = (err_f, compare_bf16(
                f"flash_bwd_dq_bhtd {what}", dq,
                ka.reference_flash_bwd_dq_bhtd(*bw, **kw)),
                max(compare_bf16(f"flash_bwd_dkv_bhtd {what} dk", dk,
                                 want_dk),
                    compare_bf16(f"flash_bwd_dkv_bhtd {what} dv", dv,
                                 want_dv)))
            del want_dk, want_dv
            if rate == 0.0:
                bw0, kw0 = bw, kw
            else:
                bw_d, kw_d = bw, kw
        del qt, kt, vt, dot
        if case != BHTD_RECORD_CASE:
            continue
        off = off_rounding(f"flash_fwd_bhtd bf16 {case}",
                           ka.flash_fwd_bhtd(q, k, v, bias, **kw0)[0],
                           ka.reference_flash_fwd_bhtd(*(a.double() for a in (
                               q, k, v, bias)), **kw0)[0])
        bw_off = _flash_bwd_off_rounding(bw0, kw0, "_bhtd")
        lq, lk, lv = (a.detach().requires_grad_() for a in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias,
                                                 scale=scale)

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    lq, lk, lv, attn_mask=bias, scale=scale)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                       retain_graph=True)

        pairs = _visible_pairs(tq, tk, causal)
        flops = b * h * pairs * dh
        rows, keys = BF16 * b * h * tq * dh, BF16 * b * h * tk * dh
        bias_bytes = BF16 * bias.numel()
        stats = F32 * 2 * b * h * tq
        hashes = ATTN_HASH_OPS * b * h * pairs
        # MMA FLOPs issued, in t x t products with the splits: the forward
        # 3 (s, p v twice), the dq walk 4, the dkv walk 6; the functions'
        # 2, 3 and 4 (``mult``)
        mma_mult = (6, 8, 12)
        for i, (kernel, line, source, fn, twin, mult, nbytes) in enumerate((
                ("flash_fwd_bhtd", 176, "flash_tc.cuh", ka.flash_fwd_bhtd,
                 ka.reference_flash_fwd_bhtd, 4,
                 2 * rows + 2 * keys + bias_bytes + stats // 2),
                ("flash_bwd_dq_bhtd", 247, "flash_bwd_tc.cuh",
                 ka.flash_bwd_dq_bhtd, ka.reference_flash_bwd_dq_bhtd, 6,
                 3 * rows + 2 * keys + bias_bytes + stats),
                ("flash_bwd_dkv_bhtd", 303, "flash_bwd_tc.cuh",
                 ka.flash_bwd_dkv_bhtd, ka.reference_flash_bwd_dkv_bhtd, 8,
                 2 * rows + 4 * keys + bias_bytes + stats))):
            args, args_d = ((q, k, v, bias), (q, k, v, bias)) if i == 0 \
                else (bw0, bw_d)
            lib = lib_fwd if i == 0 else lib_bwd
            rec = timed_record(
                kernel + "_bf16", "paddle_tpu_torch/csrc/" + source,
                f"paddle_tpu/kernels/attention.py:{line}", errs[0.0][i],
                lambda: fn(*args, **kw0), lambda: twin(*args, **kw0),
                mult * flops, nbytes, lib, b, bound_fn=bound_bf16)
            rec.update(case=case, dtype="bf16",
                       dropout_max_abs_err=errs[DROPOUT][i],
                       dropout_ms=cuda_ms(lambda: fn(*args_d, **kw_d)),
                       dropout_bound_ms=bound_bf16(mult * flops, nbytes,
                                                   hashes)[0],
                       mma_flops=mma_mult[i] * flops,
                       device_ms=cuda_ms(lambda: fn(*args, **kw0),
                                         hide_host=True),
                       dropout_device_ms=cuda_ms(
                           lambda: fn(*args_d, **kw_d), hide_host=True),
                       library_device_ms=cuda_ms(lib, hide_host=True),
                       off_rounding_share=off if i == 0 else bw_off[kernel],
                       bthd_bit_equal=[c[0] for c in BHTD_BF16_CASES])
            out[kernel + "_bf16"] = rec
        del lib_out
    odd_gen = torch.Generator().manual_seed(4)
    q, k, v, do, bias = _bf16(*_bhtd_inputs(odd_gen, 128, 128, "head"))
    _require_odd_bias_bits("flash_fwd_bhtd bf16 per-head bias",
                           lambda bias_, kw: ka.flash_fwd_bhtd(
                               q, k, v, bias_, **kw),
                           bias, dict(scale=scale, causal=False))
    o, lse = ka.flash_fwd_bhtd(q, k, v, bias, scale=scale)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    for name, fn in (("flash_bwd_dq_bhtd", lambda *a, **kw: (
            ka.flash_bwd_dq_bhtd(*a, **kw),)),
                     ("flash_bwd_dkv_bhtd", ka.flash_bwd_dkv_bhtd)):
        _require_odd_bias_bits(f"{name} bf16 per-head bias",
                               lambda bias_, kw, fn=fn: fn(
                                   q, k, v, bias_, do, lse, delta, **kw),
                               bias, dict(scale=scale, causal=False))
    return out


#: the share of bf16 inputs on which the card's bf16 gelu may differ from
#: the CPU's (an erfc that rounds its last f32 bit otherwise moves a bf16
#: rounding only near a tie)
GELU_CARD_SHARE = 1e-3


def check_gelu_bf16():
    """``ops.nn_ops.gelu`` on bf16 (the reference's bf16 arithmetic, plain
    PyTorch) on every finite bf16 input on the card against the same
    function on the CPU: the card's must give the CPU's bits on all but
    GELU_CARD_SHARE of the inputs (its erfc may round its last f32 bit
    otherwise).  Returns the counts, with the inputs on which ``F.gelu``
    in bf16 on the card differs from it."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.nn_ops import gelu

    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    cpu = gelu(x)
    card = gelu(x.cuda()).cpu()
    lib = F.gelu(x.cuda(), approximate="none").cpu()

    def differ(a, c):
        return int((~((a == c) | (a.isnan() & c.isnan()))).sum())

    rec = dict(inputs=x.numel(), card_vs_cpu=differ(card, cpu),
               f_gelu_vs_port_card=differ(lib, card))
    require(rec["card_vs_cpu"] <= GELU_CARD_SHARE * x.numel(),
            f"gelu bf16: the card differs from the CPU on "
            f"{rec['card_vs_cpu']} of {x.numel()} inputs")
    return rec


def check_qkv_bf16_bert(gen):
    """#1 and the pair #2 + #3 in bf16 at BERT-base's self-attention
    (QKV_PAIR_BERT: b 128, t 128, d_model 768, 12 heads; #1 on its plan's
    cluster route, the pair's GEMMs at K 768 and N 2304 and its dW_qkv
    over 16384 rows), the shapes phase 3 (k)'s ``use_flash`` route gives
    them, at rates 0 and DROPOUT: each called twice for equal bits and
    held to its bf16 twin by ``compare_bf16`` (y, ctx; dx, dW_qkv,
    dW_out), ctx's and the pair's shares off the float64 value rounded to
    bf16 at most TOL_OFF_ROUNDING, and each timed beside its twin and
    ``F.multi_head_attention_forward`` in bf16 (its backward for the
    pair), with and without the host's enqueue.  Returns
    {"qkv_attention_fwd": record, "qkv_bwd": record}."""
    from paddle_tpu_torch.kernels import attention as ka

    case, b, t, dm, bias_kind, causal = QKV_PAIR_BERT
    h, dh = dm // 64, 64
    hd = h * dh
    x, w_qkv, w_out, g, bias = _bf16(*_qkv_inputs(gen, t, bias_kind, b, dm))
    fw = (x, w_qkv, w_out, bias)
    errs, bws = {}, {}
    for rate in (0.0, DROPOUT):
        kw = dict(n_head=h, scale=dh ** -0.5, causal=causal,
                  dropout_rate=rate, dropout_seed=int(torch.randint(
                      0, 2 ** 32, (1,), generator=gen)))
        what = f"bf16 {case} rate {rate}"
        (y, ctx, lse), _, _, err_f = _held_qkv_fwd(
            f"qkv_attention_fwd {what}", fw, kw, False)
        bw = (x, w_qkv, w_out, bias, g, ctx, lse)
        got = ka.qkv_bwd(*bw, **kw)
        require(all(torch.equal(a, c) for a, c in zip(
            got, ka.qkv_bwd(*bw, **kw))), f"qkv_bwd {what}: two calls "
            "differ")
        err_b = max(compare_bf16(f"qkv_bwd {what} {part}", a, w)
                    for part, a, w in zip(("dx", "dW_qkv", "dW_out"), got,
                                          ka.reference_qkv_bwd(*bw, **kw)))
        del got
        errs[rate], bws[rate] = (err_f, err_b), (bw, kw)
    (bw, kw), (bw_d, kw_d) = bws[0.0], bws[DROPOUT]
    off = off_rounding(f"qkv_attention_fwd bf16 {case} ctx",
                       ka.qkv_attention_fwd(*fw, **kw)[1],
                       ka.reference_qkv_fwd(*(a.double() for a in fw),
                                            **kw)[1])
    pair_off = _pair_off_rounding(bw, kw)
    _, lib_fwd, lib_bwd = _library_mha(x, w_qkv, w_out, bias, g, h, causal)
    pairs = _visible_pairs(t, t, causal)
    proj, attn = 2 * b * t * dm * hd, 2 * b * h * pairs * dh
    hashes = ATTN_HASH_OPS * b * h * pairs
    io = (BF16 * (b * t * hd + dm * 3 * hd + hd * dm + bias.numel())
          + F32 * b * h * t)
    act = BF16 * b * t * dm
    pair_bytes = BF16 * (3 * b * t * dm + b * t * hd + bias.numel()
                         + 2 * (dm * 3 * hd + hd * dm)) + F32 * b * h * t
    out = {}
    for name, source, line, i, fn, twin, flops, nbytes, lib in (
            ("qkv_attention_fwd", "qkv_attention.cu", "1377", 0,
             ka.qkv_attention_fwd, ka.reference_qkv_fwd,
             4 * proj + 2 * attn, 2 * act + io, lib_fwd),
            ("qkv_bwd", "qkv_attention_bwd.cu", "1454 + :1546", 1,
             ka.qkv_bwd, ka.reference_qkv_bwd, _qkv_pair_flops(proj, attn),
             pair_bytes, lib_bwd)):
        args, args_d = (fw, fw) if i == 0 else (bw, bw_d)
        rec = timed_record(
            name + "_bf16", "paddle_tpu_torch/csrc/" + source,
            f"paddle_tpu/kernels/attention.py:{line}", errs[0.0][i],
            lambda: fn(*args, **kw), lambda: twin(*args, **kw), flops,
            nbytes, lib, b, bound_fn=bound_bf16)
        rec.update(case=case, t=t, d_model=dm, dtype="bf16",
                   dropout_max_abs_err=errs[DROPOUT][i],
                   dropout_ms=cuda_ms(lambda: fn(*args_d, **kw_d)),
                   dropout_bound_ms=bound_bf16(flops, nbytes, hashes)[0],
                   device_ms=cuda_ms(lambda: fn(*args, **kw),
                                     hide_host=True),
                   library_device_ms=cuda_ms(lib, hide_host=True),
                   off_rounding_share=off if i == 0 else pair_off)
        if i == 0:
            rec["plan"] = list(ka.qkv_fwd_plan(b, t, h,
                                               ka.sm_count(x.device)))
        out[name] = rec
    return out



def check_qkv_bf16(gen):
    """#1 and the pair #2 + #3 in bf16 (amp) against their bf16 twins on
    QKV_CASES at rates 0 and DROPOUT, each called twice for equal bits, by
    ``compare_bf16`` (y, ctx, dx, dW_qkv, dW_out bf16; lse f32); a masked
    row's ctx must be 0.  At the record case #1, the pair, and #2 and #3
    alone are timed beside their twins and ``F.multi_head_attention_
    forward`` in bf16 (its backward for the pair), bounds at 2 bytes an
    element and the bf16 tensor-core rate.  Returns {kernel name: record}
    (#2's and #3's carry the pair's under "pair")."""
    from paddle_tpu_torch.kernels import attention as ka

    b, h, dh, dm = (TRAIN_BATCH, BASE["n_head"], BASE["d_key"],
                    BASE["d_model"])
    hd = h * dh
    out = {}
    for case, t, bias_kind, causal in QKV_CASES:
        x, w_qkv, w_out, g, bias = _bf16(*_qkv_inputs(gen, t, bias_kind))
        fw = (x, w_qkv, w_out, bias)
        errs, bws = {}, {}
        for rate in (0.0, DROPOUT):
            kw = dict(n_head=h, scale=dh ** -0.5, causal=causal,
                      dropout_rate=rate, dropout_seed=int(torch.randint(
                          0, 2 ** 32, (1,), generator=gen)))
            what = f"bf16 {case} rate {rate}"
            (y, ctx, lse), _, _, err_f = _held_qkv_fwd(
                f"qkv_attention_fwd {what}", fw, kw, bias_kind == "masked")
            require(y.dtype == ctx.dtype == torch.bfloat16,
                    f"qkv_attention_fwd {what}: y {y.dtype}, ctx {ctx.dtype}")
            bw = (x, w_qkv, w_out, bias, g, ctx, lse)
            errs[rate] = [err_f]
            for kernel, fn, twin in (
                    ("qkv_bwd", ka.qkv_bwd, ka.reference_qkv_bwd),
                    ("qkv_bwd_dq", ka.qkv_bwd_dq, ka.reference_qkv_bwd_dq),
                    ("qkv_bwd_dkv", ka.qkv_bwd_dkv,
                     ka.reference_qkv_bwd_dkv)):
                got_b = fn(*bw, **kw)
                require(all(torch.equal(a, c) for a, c in zip(
                    got_b, fn(*bw, **kw))),
                    f"{kernel} {what}: two calls differ")
                errs[rate].append(max(
                    compare_bf16(f"{kernel} {what} part {i}", a, w)
                    for i, (a, w) in enumerate(zip(got_b,
                                                   twin(*bw, **kw)))))
                if kernel == "qkv_bwd_dq" and bias_kind == "masked":
                    # the row masked in the forward (lse = +inf) gets dq
                    # = 0, so its dx_q = dq W_q^T is exactly 0
                    require(torch.isinf(lse[-1, :, t - 5]).all().item()
                            and not got_b[0][-1, t - 5].any().item(),
                            f"{kernel} {what}: the masked row's dx_q is "
                            "not 0")
                del got_b
            bws[rate] = (bw, kw)
        if case != QKV_RECORD_CASE:
            continue
        (bw, kw), (bw_d, kw_d) = bws[0.0], bws[DROPOUT]
        off = off_rounding(f"qkv_attention_fwd bf16 {case} ctx",
                           ka.qkv_attention_fwd(*fw, **kw)[1],
                           ka.reference_qkv_fwd(*(a.double() for a in fw),
                                                **kw)[1])
        pair_off = _pair_off_rounding(bw, kw)
        _, lib_fwd, lib_bwd = _library_mha(x, w_qkv, w_out, bias, g, h,
                                           causal)
        pairs = _visible_pairs(t, t, causal)
        proj = 2 * b * t * dm * hd
        attn = 2 * b * h * pairs * dh
        hashes = ATTN_HASH_OPS * b * h * pairs
        io = (BF16 * (b * t * hd + dm * 3 * hd + hd * dm + bias.numel())
              + F32 * b * h * t)
        act = BF16 * b * t * dm
        pair_bytes = BF16 * (3 * b * t * dm + b * t * hd + bias.numel()
                             + 2 * (dm * 3 * hd + hd * dm)) + F32 * b * h * t
        src = "paddle_tpu_torch/csrc/qkv_attention_bwd.cu"
        for name, source, line, err_i, fn, twin, flops, nbytes, lib in (
                ("qkv_attention_fwd", "paddle_tpu_torch/csrc/"
                 "qkv_attention.cu", "1377", 0, ka.qkv_attention_fwd,
                 ka.reference_qkv_fwd, 4 * proj + 2 * attn, 2 * act + io,
                 lib_fwd),
                ("qkv_bwd", src, "1454 + :1546", 1, ka.qkv_bwd,
                 ka.reference_qkv_bwd, _qkv_pair_flops(proj, attn),
                 pair_bytes, lib_bwd),
                ("qkv_bwd_dq", src, "1454", 2, ka.qkv_bwd_dq,
                 ka.reference_qkv_bwd_dq, 7 * proj + 3 * attn,
                 3 * act + io + BF16 * 2 * dm * hd, lib_bwd),
                ("qkv_bwd_dkv", src, "1546", 3, ka.qkv_bwd_dkv,
                 ka.reference_qkv_bwd_dkv, 8 * proj + 4 * attn,
                 3 * act + io + BF16 * 2 * dm * hd, lib_bwd)):
            args, args_d = (fw, fw) if err_i == 0 else (bw, bw_d)
            rec = timed_record(
                name + "_bf16", source,
                f"paddle_tpu/kernels/attention.py:{line}", errs[0.0][err_i],
                lambda: fn(*args, **kw), lambda: twin(*args, **kw), flops,
                nbytes, lib, b, bound_fn=bound_bf16)
            rec.update(case=case, dtype="bf16",
                       dropout_max_abs_err=errs[DROPOUT][err_i],
                       dropout_ms=cuda_ms(lambda: fn(*args_d, **kw_d)),
                       dropout_bound_ms=bound_bf16(flops, nbytes,
                                                   hashes)[0])
            if name in ("qkv_attention_fwd", "qkv_bwd"):
                # the parent's kernels (#1: tensor cores; the pair: the
                # CUDA cores), same inputs
                tensor_core_times(rec, lambda: fn(*args, **kw),
                                  lambda: fn(*args_d, **kw_d), lib)
            if name == "qkv_attention_fwd":
                rec["plan"] = list(ka.qkv_fwd_plan(b, t, h,
                                                   ka.sm_count(x.device)))
                rec["off_rounding_share"] = off
            elif name == "qkv_bwd":
                rec["off_rounding_share"] = pair_off
                rec["stages"] = _pair_stages(lambda: fn(*args, **kw), b, t,
                                             dm, hd)
            out[name + "_bf16"] = rec
        for name in ("qkv_bwd_dq_bf16", "qkv_bwd_dkv_bf16"):
            out[name]["pair"] = {k: out["qkv_bwd_bf16"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "dropout_ms", "dropout_bound_ms",
                "device_ms", "parent_ms", "parent_device_ms",
                "dropout_device_ms", "parent_dropout_ms",
                "library_device_ms", "off_rounding_share", "stages")}
        del lib_fwd, lib_bwd
    out.pop("qkv_bwd_bf16")
    # #1 in bf16 on every route of the plan (QKV_PLAN_CASES: clusters of
    # 1 to 8 blocks of R 32 and 64, the tiles route, y split over K at
    # small b * t), on a generator of its own so that the later checks
    # draw the inputs they drew before
    plan_gen = torch.Generator().manual_seed(1)
    plans = {}
    for name, b_, t, dm, bias_kind, causal in QKV_PLAN_CASES:
        fw = _bf16(*_qkv_inputs(plan_gen, t, bias_kind, b_, dm))
        del fw[3]  # g
        errs = []
        for rate in (0.0, DROPOUT):
            kw = dict(n_head=dm // 64, scale=dh ** -0.5, causal=causal,
                      dropout_rate=rate, dropout_seed=int(torch.randint(
                          0, 2 ** 32, (1,), generator=plan_gen)))
            errs.append(_held_qkv_fwd(
                f"qkv_attention_fwd bf16 {name} rate {rate}", fw, kw,
                bias_kind == "masked")[3])
        plans[name] = dict(plan=list(ka.qkv_fwd_plan(
            b_, t, dm // 64, ka.sm_count(fw[0].device))), max_abs_err=errs[0],
            dropout_max_abs_err=errs[1])
        del fw
    out["qkv_attention_fwd_bf16"]["plans"] = plans
    odd_gen = torch.Generator().manual_seed(4)
    for b_ in (None, 1):  # clusters of R 64 and of R 32
        x, w_qkv, w_out, _, bias = _qkv_inputs(odd_gen, 256, "decoder", b_)
        x, w_qkv, w_out, bias = _bf16(x, w_qkv, w_out,
                                      bias + randn(odd_gen, *bias.shape))
        plan = ka.qkv_fwd_plan(x.shape[0], 256, h, ka.sm_count(x.device))
        _require_odd_bias_bits(
            f"qkv_attention_fwd bf16 decoder self {plan}",
            lambda bias_, kw: ka.qkv_attention_fwd(x, w_qkv, w_out, bias_,
                                                   **kw),
            bias, dict(n_head=h, scale=dh ** -0.5, causal=False))
    return out


def _off_rounding_shares(what, names, fn, exact, parent_has=True):
    """The share of each of fn()'s bf16 outputs ``names`` off ``exact``
    (the float64 twin's) rounded to bf16, for this tree's kernels and (with
    ``--parent``, where ``parent_has`` the kernels) the parent's: {"tree":
    [...], "parent": [...] or None}; each of the tree's at most
    TOL_OFF_ROUNDING (compare_bf16 cannot tell whether an f32
    intermediate keeps its hi/lo split)."""
    tree = [off_rounding(f"{what} {n}", a, e)
            for n, a, e in zip(names, fn(), exact)]
    parent = None
    if parent_has and parent_lib() is not None:
        with kernel_library(parent_lib()):
            got = fn()
            torch.cuda.synchronize()
        parent = [(a != e.to(a.dtype)).double().mean().item()
                  for a, e in zip(got, exact)]
    return dict(tree=tree, parent=parent)


def _pair_off_rounding(bw, kw):
    """The bf16 pair's dx, dW_qkv and dW_out (walks 3):
    ``_off_rounding_shares``."""
    from paddle_tpu_torch.kernels import attention as ka

    return _off_rounding_shares(
        "qkv_bwd bf16", ("dx", "dW_qkv", "dW_out"),
        lambda: ka.qkv_bwd(*bw, **kw),
        ka.reference_qkv_bwd(*(None if a is None else a.double()
                               for a in bw), **kw))


#: the pair's five products at a shape (b t rows, d_model dm, h 64 = hd):
#: (name, M, N, K, a transposed, b transposed), as ``torch.matmul`` takes
#: them in bf16
def _pair_products(bt, dm, hd):
    return (("q|k|v = x W_qkv", bt, 3 * hd, dm, False, False),
            ("dctx = g W_out^T", bt, hd, dm, False, True),
            ("dx = dqkv W_qkv^T", bt, dm, 3 * hd, False, True),
            ("dW_qkv = x^T dqkv", dm, 3 * hd, bt, True, False),
            ("dW_out = ctx^T g", hd, dm, bt, True, False))


def _pair_stages(fn, b, t, dm, hd):
    """Where one bf16 pair call's device time goes (``torch.profiler``,
    the median of 5 calls): its GEMM stages (the tile, split-K sums
    included) and its two walks, beside ``torch.matmul`` in bf16 on the
    pair's five products (device time, each timed alone after an L2
    flush)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    gemm, walks, other = [], [], []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = _device_kernels(prof)
        gemm.append(_gemm_cuh_us(rows) / 1e3)
        walks.append(_walks_us(rows) / 1e3)
        other.append(sum(us for _, us in rows) / 1e3 - gemm[-1] - walks[-1])
    gen = torch.Generator().manual_seed(5)
    matmul = {}
    for name, m, n, k, a_t, b_t in _pair_products(b * t, dm, hd):
        a = (randn(gen, k, m).t() if a_t else randn(gen, m, k)).bfloat16()
        w = (randn(gen, n, k).t() if b_t else randn(gen, k, n)).bfloat16()
        matmul[name] = cuda_ms(lambda: torch.matmul(a, w), hide_host=True)
    return dict(gemm_ms=float(np.median(gemm)),
                walks_ms=float(np.median(walks)),
                other_ms=float(np.median(other)),
                matmul_ms=matmul, matmul_sum_ms=sum(matmul.values()))


#: bf16 patterns of phase 2's special inputs to #16 and #17, each also
#: negated: +0, the least and largest subnormals, the least normal, 1,
#: 1.5, the largest x whose product with 1.109375 (rate 0.1) stays finite
#: (0x7F66) and the least that overflows (0x7F67), 0x7F70, the largest
#: finite value, inf and NaN
SPECIAL_BF16 = (0x0000, 0x0001, 0x007F, 0x0080, 0x3F80, 0x3FC0, 0x7F66,
                0x7F67, 0x7F70, 0x7F7F, 0x7F80, 0x7FC0)


def _bf16_of_bits(bits):
    """A bf16 tensor on the card holding the 16-bit patterns ``bits``."""
    return torch.from_numpy(np.asarray(bits, np.uint16).view(
        np.int16)).view(torch.bfloat16).cuda()


def same_bf16_bits(a, b):
    """True where the bf16 ``a`` and ``b`` hold the same bits everywhere,
    a NaN matching any NaN (the card's canonical NaN need not be the
    twin's)."""
    nan = a.isnan()
    return (torch.equal(nan, b.isnan())
            and torch.equal(a.view(torch.int16)[~nan],
                            b.view(torch.int16)[~nan]))


def dropout_bf16_cases(gen):
    """[(name, x, residual)] of bf16 inputs on the card that test #16's
    and #17's packed bf16x2 arithmetic against the twins' f32-then-rounded
    one: every bf16 pattern of x (each at 4 indices, so that nearly each
    is kept at least once) beside a random residual; residuals that put
    the sum with x's product (rounded to bf16) on a tie at its last bit,
    at 1.5 and 2.5 steps or just off one, and residuals 9-30 binades below
    the product; SPECIAL_BF16 against SPECIAL_BF16; a numel of 8k + 5
    (the vector path and a 5-element tail) and views at an odd element
    (the element-by-element path)."""
    from paddle_tpu_torch.kernels import dropout_epilogue as kde

    cases = []
    every = np.tile(np.arange(2 ** 16), 4)
    cases.append(("every x pattern", _bf16_of_bits(every),
                  randn(gen, every.size).bfloat16()))
    n = 2 ** 18
    x = randn(gen, n).bfloat16()
    p = (x * kde._scale(DROPOUT, torch.bfloat16)).float()
    _, e = torch.frexp(p)  # |p| = m 2^e, m in [0.5, 1): p's step 2^(e-8)
    sign = torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0).cuda()
    steps = torch.tensor((1.0, 1.0 + 2 ** -7, 1.0 - 2 ** -8, 3.0, 5.0))
    half = steps[torch.randint(0, 5, (n,), generator=gen)].cuda()
    cases.append(("ties", x, (sign * torch.ldexp(half, e - 9)).bfloat16()))
    gap = torch.randint(9, 31, (n,), generator=gen).cuda()
    frac = 1 + torch.randint(0, 128, (n,), generator=gen).cuda() / 128
    cases.append(("exponent gaps 9-30", x,
                  (sign * torch.ldexp(frac, e - 1 - gap)).bfloat16()))
    special = [b | sign for b in SPECIAL_BF16 for sign in (0, 0x8000)]
    xs, rs = np.meshgrid(special, special)
    cases.append(("specials", _bf16_of_bits(np.tile(xs.ravel(), 16)),
                  _bf16_of_bits(np.tile(rs.ravel(), 16))))
    odd = 8 * 4099 + 5
    cases.append(("numel 8k + 5", randn(gen, odd).bfloat16(),
                  randn(gen, odd).bfloat16()))
    xb, rb = (randn(gen, odd + 1).bfloat16() for _ in range(2))
    cases.append(("views at element 1", xb[1:], rb[1:]))
    return cases


def check_dropout_bf16_bits(gen):
    """#16 (with and without a residual) and #17 in bf16 on each of
    ``dropout_bf16_cases``: the twins' bits (a NaN matching any NaN), and
    with ``--parent`` the parent's kernels' too.  Returns {case: numel}."""
    from paddle_tpu_torch.kernels import dropout_epilogue as kde

    held = {}
    for name, x, res in dropout_bf16_cases(gen):
        seed = int(torch.randint(0, 2 ** 32, (1,), generator=gen))
        calls = (
            ("dropout_add_fwd", lambda: kde.dropout_add_fwd(
                x, res, DROPOUT, seed), lambda: kde.reference_dropout_add(
                x, res, DROPOUT, seed)),
            ("dropout_add_fwd no residual", lambda: kde.dropout_add_fwd(
                x, None, DROPOUT, seed), lambda: kde.reference_dropout_add(
                x, None, DROPOUT, seed)),
            ("dropout_add_bwd", lambda: kde.dropout_add_bwd(
                x, DROPOUT, seed), lambda: kde.reference_dropout_add_bwd(
                x, DROPOUT, seed)))
        for what, fn, twin in calls:
            got, want = fn(), twin()
            torch.cuda.synchronize()
            require(got.dtype == torch.bfloat16 and same_bf16_bits(got, want),
                    f"{what} bf16 on {name}: not the twin's bits")
            if parent_lib() is not None:
                with kernel_library(parent_lib()):
                    theirs = fn()
                    torch.cuda.synchronize()
                require(same_bf16_bits(got, theirs),
                        f"{what} bf16 on {name}: not the parent's bits")
        held[name] = x.numel()
    return held


def _same_bytes(rec, fn, call, prefix="",
                note="same bytes, not the same function"):
    """Add to ``rec`` the times of ``fn``, one PyTorch call that moves the
    kernel's bytes (``call`` names it; ``note`` says how far), with and
    without the host's enqueue: a yardstick of the card's copy rate, not
    the same function."""
    rec[prefix + "same_bytes"] = f"{call}: {note}"
    rec[prefix + "same_bytes_ms"] = cuda_ms(fn)
    rec[prefix + "same_bytes_device_ms"] = cuda_ms(fn, hide_host=True)


def _clean_flush(rec, fn, same_bytes):
    """Add to ``rec`` the device-only times of the kernel ``fn``, of the
    parent's (with ``--parent``) and of its same-bytes call after a flush
    that leaves the L2's lines clean (``cuda_ms(clean=True)``): no dirty
    line of the flush is written back in their time."""
    kw = dict(hide_host=True, clean=True)
    rec.update(clean_flush_device_ms=cuda_ms(fn, **kw),
               clean_flush_parent_device_ms=parent_ms(fn, **kw),
               clean_flush_same_bytes_device_ms=cuda_ms(same_bytes, **kw))


def check_dropout_add_bf16(gen):
    """#16 (with and without a residual) and #17 in bf16 (amp) at
    [32*256, 512], the amp step's residual sites: equal to their bf16
    twins bit for bit (the reference's bf16 arithmetic) and to themselves
    on a repeat, and so on ``dropout_bf16_cases`` (and the parent's
    kernels, with ``--parent``); timed beside the twins with and without
    the host's enqueue, beside the parent's kernels and beside the
    same-bytes ``torch.add(x, r)`` (#16) and ``torch.mul(g, s)`` (#17,
    #16 without a residual), and again after a flush that leaves the L2
    clean (``_clean_flush``); bounds at 2 bytes an element.  Returns
    (#16's record, #17's record)."""
    from paddle_tpu_torch.kernels import dropout_epilogue as kde

    shape = (DROPOUT_ROWS, BASE["d_model"])
    n = DROPOUT_ROWS * BASE["d_model"]
    seed = int(torch.randint(0, 2 ** 32, (1,), generator=gen))
    x, res, g = _bf16(*(randn(gen, *shape) for _ in range(3)))
    for what, fn, twin in (
            ("dropout_add_fwd", lambda: kde.dropout_add_fwd(
                x, res, DROPOUT, seed), lambda: kde.reference_dropout_add(
                x, res, DROPOUT, seed)),
            ("dropout_add_fwd no residual", lambda: kde.dropout_add_fwd(
                x, None, DROPOUT, seed), lambda: kde.reference_dropout_add(
                x, None, DROPOUT, seed)),
            ("dropout_add_bwd", lambda: kde.dropout_add_bwd(
                g, DROPOUT, seed), lambda: kde.reference_dropout_add_bwd(
                g, DROPOUT, seed))):
        got, again, want = fn(), fn(), twin()
        torch.cuda.synchronize()
        require(got.dtype == torch.bfloat16 and torch.equal(got, again)
                and torch.equal(got, want),
                f"{what} bf16: not the twin's bits or not repeated")
    cases = check_dropout_bf16_bits(gen)
    src = "paddle_tpu_torch/csrc/dropout_add.cu"
    scale = float(kde._scale(DROPOUT, torch.bfloat16))

    def fwd_fn():
        return kde.dropout_add_fwd(x, res, DROPOUT, seed)

    def plain_fn():
        return kde.dropout_add_fwd(x, None, DROPOUT, seed)

    def bwd_fn():
        return kde.dropout_add_bwd(g, DROPOUT, seed)

    fwd = timed_record(
        "dropout_add_fwd_bf16", src,
        "paddle_tpu/kernels/dropout_epilogue.py:62", 0.0, fwd_fn,
        lambda: kde.reference_dropout_add(x, res, DROPOUT, seed), 0,
        3 * BF16 * n, None, TRAIN_BATCH, int_ops=HASH_OPS * n,
        bound_fn=bound_bf16)
    tensor_core_times(fwd, fwd_fn)
    _same_bytes(fwd, lambda: torch.add(x, res), "torch.add(x, r)")
    _clean_flush(fwd, fwd_fn, lambda: torch.add(x, res))
    fwd.update(dtype="bf16", twin_bit_equal=True, bit_cases=cases,
               no_residual_ms=cuda_ms(plain_fn),
               no_residual_device_ms=cuda_ms(plain_fn, hide_host=True),
               no_residual_parent_device_ms=parent_ms(plain_fn,
                                                      hide_host=True),
               no_residual_bound_ms=bound_bf16(0, 2 * BF16 * n,
                                               HASH_OPS * n)[0])
    _same_bytes(fwd, lambda: torch.mul(x, scale), "torch.mul(x, s)",
                prefix="no_residual_")
    bwd = timed_record(
        "dropout_add_bwd_bf16", src,
        "paddle_tpu/kernels/dropout_epilogue.py:76", 0.0, bwd_fn,
        lambda: kde.reference_dropout_add_bwd(g, DROPOUT, seed), 0,
        2 * BF16 * n, None, TRAIN_BATCH, int_ops=HASH_OPS * n,
        bound_fn=bound_bf16)
    tensor_core_times(bwd, bwd_fn)
    _same_bytes(bwd, lambda: torch.mul(g, scale), "torch.mul(g, s)")
    _clean_flush(bwd, bwd_fn, lambda: torch.mul(g, scale))
    bwd.update(dtype="bf16", twin_bit_equal=True, bit_cases=cases)
    for r in (fwd, bwd):
        r["device_bound_share"] = r["bound_ms"] / r["device_ms"]
    return fwd, bwd


# ---------------------------------------------------------------------------
# the bf16 kernels on tensor cores (#4, #1's cluster route and its y tile):
# their SASS; and the parent checkout's kernels beside them (--parent)
# ---------------------------------------------------------------------------

#: the tensor-core kernels (fragments of their mangled names) and the
#: source whose object ``sass_mma`` reads for each: #4 and the walks of #6
#: and #7 (one bf16 plane), #1's cluster route and its y tile, the pair's
#: walks (hi/lo planes) and its GEMM stages (the tile in the pair's five
#: layouts), and the tile as gemm.cu exports it
TC_KERNELS = (("flash_fwd_tc_kernel", "flash_attention.cu"),
              ("flash_dq_tc_kernel", "flash_attention.cu"),
              ("flash_dkv_tc_kernel", "flash_attention.cu"),
              ("qkv_cluster_tc_kernel", "qkv_attention.cu"),
              ("gemm_tc_kernel", "qkv_attention.cu"),
              ("bwd_dq_tc_kernel", "qkv_attention_bwd.cu"),
              ("bwd_dkv_tc_kernel", "qkv_attention_bwd.cu"),
              ("gemm_tc_kernel", "qkv_attention_bwd.cu"),
              ("gemm_tc_kernel", "gemm.cu"))


def sass_mma(build):
    """{"source: function": MMA instructions} of every instantiation of
    TC_KERNELS in the built object of its source (``cuobjdump -sass``):
    lines of HMMA (mma.sync) or HGMMA (wgmma).  ``build`` is the
    ``_build`` module.  Raises if a kernel has no instantiation in its
    source, or one without an MMA instruction: a "tensor-core" kernel that
    compiled to FMAs fails the run."""
    import re

    obj_dir = os.path.join(build.BUILD_DIR, f"obj-{build._digest()}")
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    counts = {}
    for src in sorted({s for _, s in TC_KERNELS}):
        kernels = [k for k, s in TC_KERNELS if s == src]
        sass = subprocess.run(
            [tool, "-sass", os.path.join(obj_dir, src[:-3] + ".o")],
            capture_output=True, text=True, check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = (f"{src}: {m.group(1)}" if any(k in m.group(1)
                                                    for k in kernels)
                      else None)
                if fn:
                    counts[fn] = 0
            elif fn and re.search(r"\sHG?MMA\.", line):
                counts[fn] += 1
    for kernel, src in TC_KERNELS:
        found = {f: n for f, n in counts.items()
                 if f.startswith(src + ":") and kernel in f}
        require(found, f"{kernel}: no instantiation in {src}'s SASS")
        require(all(found.values()), f"{kernel}: no HMMA/HGMMA in "
                f"{[f for f, n in found.items() if not n]}")
    return counts


#: the parent checkout's sources built for the A/B: every entry point the
#: redesigned kernels' wrappers, the bit check and the amp step reach
PARENT_SOURCES = ("flash_attention.cu", "qkv_attention.cu",
                  "qkv_attention_bwd.cu", "gemm.cu", "dropout_add.cu",
                  "conv_bn.cu")
_PARENT = {}


def start_parent_build(root):
    """Start compiling the PARENT_SOURCES of the checkout at ``root`` (one
    nvcc each, all at once, with this tree's flags) into this tree's
    ``paddle_tpu_torch/_build/parent_ab``; :func:`parent_lib` waits for
    them."""
    from paddle_tpu_torch.kernels import _build

    csrc = os.path.join(os.path.abspath(root), "paddle_tpu_torch", "csrc")
    _PARENT["root"] = os.path.abspath(root)
    out = os.path.join(_build.BUILD_DIR, "parent_ab")
    os.makedirs(out, exist_ok=True)
    jobs = [(src, os.path.join(out, src[:-3] + ".o")) for src in
            PARENT_SOURCES]
    _PARENT.update(out=out, jobs=[(src, obj, subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-c",
         os.path.join(csrc, src), "-o", obj], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for src, obj in jobs])


def parent_lib():
    """The parent checkout's library, its entry points bound with this
    tree's signatures; None without ``--parent``.  Its ptxas lines are in
    ``_PARENT["log"]``."""
    if "jobs" not in _PARENT:
        return None
    if "lib" not in _PARENT:
        from paddle_tpu_torch.kernels import _build

        log = []
        for src, _, proc in _PARENT["jobs"]:
            out, _ = proc.communicate()
            require(proc.returncode == 0, f"parent's {src}: nvcc failed\n"
                    f"{out}")
            log.append(f"== {src} (rc 0)\n{out}")
        so = os.path.join(_PARENT["out"], "libparent.so")
        link = subprocess.run(
            [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-shared", "-o", so, *(obj for _, obj, _ in _PARENT["jobs"])],
            capture_output=True, text=True)
        require(link.returncode == 0, f"parent's link failed: {link.stdout}"
                f"{link.stderr}")
        lib = ctypes.CDLL(so)
        mine = _entry_params(_build.CSRC_DIR)
        theirs = _entry_params(os.path.join(_PARENT["root"],
                                            "paddle_tpu_torch", "csrc"))
        shims = {}
        for name, (restype, argtypes) in _build._SIGNATURES.items():
            if not hasattr(lib, name):
                continue
            fn = getattr(lib, name)
            keep = [i for i, p in enumerate(mine[name]) if p in theirs[name]]
            require([mine[name][i] for i in keep] == theirs[name],
                    f"parent's {name}: parameters {theirs[name]} are not "
                    f"a subsequence of {mine[name]}")
            fn.restype = restype
            fn.argtypes = [argtypes[i] for i in keep]
            if len(keep) < len(argtypes):
                # the tree's call with the arguments the parent lacks
                # (a width it did not take) left out
                shims[name] = (lambda fn, keep: lambda *a: fn(
                    *(a[i] for i in keep)))(fn, keep)
        _PARENT.update(lib=_Shimmed(lib, shims), log="\n".join(log))
    return _PARENT["lib"]


def _entry_params(csrc):
    """{entry point: [parameter names]} of the ``extern "C"`` functions of
    ``csrc``'s ``*.cu`` files."""
    import glob
    import re

    src = "\n".join(open(f).read() for f in sorted(
        glob.glob(os.path.join(csrc, "*.cu"))))
    return {m.group(1): [p.split()[-1].lstrip("*") for p in
                         m.group(2).split(",") if p.strip()
                         and p.strip() != "void"]
            for m in re.finditer(r'extern "C"[\w\s*]+?\b(ptt_\w+)\s*'
                                 r'\(([^)]*)\)', src)}


class _Shimmed:
    """A kernel library whose entry points take this tree's arguments:
    ``shims`` (name: callable) where the parent's take fewer."""

    def __init__(self, lib, shims):
        self._lib, self._shims = lib, shims

    def __getattr__(self, name):
        if name in self._shims:
            return self._shims[name]
        return getattr(self._lib, name)


@contextlib.contextmanager
def kernel_library(lib):
    """The wrappers launch ``lib``'s kernels (the parent's) meanwhile."""
    from paddle_tpu_torch.kernels import _build

    saved, _build._lib = _build._lib, lib
    try:
        yield
    finally:
        _build._lib = saved


def parent_ms(fn, **kw):
    """fn's ``cuda_ms`` (its keywords ``kw``) with the parent's kernels;
    None without them."""
    lib = parent_lib()
    if lib is None:
        return None
    with kernel_library(lib):
        return cuda_ms(fn, **kw)


def tensor_core_times(rec, fn, fn_d=None, lib=None):
    """Add to the record of a redesigned kernel its device-only time
    (``cuda_ms(hide_host=True)``: the host's enqueue hidden) and the
    parent's kernel's times on the same inputs (with and without the
    enqueue); ``fn_d``'s (at DROPOUT) and the library call ``lib``'s
    device-only time, where given."""
    rec.update(device_ms=cuda_ms(fn, hide_host=True),
               parent_ms=parent_ms(fn),
               parent_device_ms=parent_ms(fn, hide_host=True))
    if fn_d is not None:
        rec.update(dropout_device_ms=cuda_ms(fn_d, hide_host=True),
                   parent_dropout_ms=parent_ms(fn_d))
    if lib is not None:
        rec["library_device_ms"] = cuda_ms(lib, hide_host=True)


def check_parent_bits(gen):
    """With ``--parent``: the kernels this tree keeps as they were, each
    called on the same inputs with this tree's library and with the
    parent's, must give the same bits: #4-#9 in f32 and #4, #6, #7 in
    bf16 on the decoder self-attention (BERT-base's for the bhtd ones), #1
    in f32 on the cluster route (R 64 and 32) and the tiles route, #1 in
    bf16 with its y on the cluster route (R 64) and the tiles route, the
    pair #2 + #3 in f32 and in bf16 (both walks), ``gemm.cuh``'s f32 tile
    at the pair's products and its tensor-core tile at GEMM_AMP_CASES, #19
    (its tile) at ResNet-50's stage-1 conv3, #18 at the stem and at C 6,
    #20 and #21 in f32 at every CBN_SSA_CASES, and #16, #17 in f32 and bf16,
    each at rates 0 and DROPOUT where it drops.  (#5, #8 and #9 in bf16
    are new: the parent has no bf16 bhtd kernels.)  ``gen`` is a generator
    of its own, so that the later checks draw the parent's inputs.
    Returns the names held, or None without a parent."""
    lib = parent_lib()
    if lib is None:
        return None
    from paddle_tpu_torch.kernels import attention as ka
    from paddle_tpu_torch.kernels import conv_bn as kc
    from paddle_tpu_torch.kernels import dropout_epilogue as kde
    from paddle_tpu_torch.kernels import gemm as kg

    held = []

    def same(name, fn):
        mine = fn()
        with kernel_library(lib):
            theirs = fn()
        torch.cuda.synchronize()
        mine, theirs = ((a,) if torch.is_tensor(a) else tuple(a)
                        for a in (mine, theirs))
        require(all((a is None and c is None) or torch.equal(a, c)
                    for a, c in zip(mine, theirs)),
                f"{name}: not the parent's bits")
        held.append(name)

    h, dh = BASE["n_head"], BASE["d_key"]
    for rate in (0.0, DROPOUT):
        seed = int(torch.randint(0, 2 ** 32, (1,), generator=gen))
        for dtype in ("f32", "bf16"):
            q, k, v, do, bias = _flash_inputs(gen, 256, 256, "decoder",
                                              False)
            if dtype == "bf16":
                q, k, v, do, bias = _bf16(q, k, v, do, bias)
            kw = dict(scale=dh ** -0.5, causal=False, dropout_rate=rate,
                      dropout_seed=seed)
            same(f"flash_fwd {dtype} rate {rate}",
                 lambda: ka.flash_fwd(q, k, v, bias, **kw))
            o, lse = ka.flash_fwd(q, k, v, bias, **kw)
            delta = (do.float() * o.float()).sum(-1).transpose(
                1, 2).contiguous()
            bw = (q, k, v, bias, do, lse, delta)
            same(f"flash_bwd_dq {dtype} rate {rate}",
                 lambda: ka.flash_bwd_dq(*bw, **kw))
            same(f"flash_bwd_dkv {dtype} rate {rate}",
                 lambda: ka.flash_bwd_dkv(*bw, **kw))
        q, k, v, do, bias = _bhtd_inputs(gen, 128, 128, "pad")
        kw = dict(scale=0.125, causal=False, dropout_rate=rate,
                  dropout_seed=seed)
        same(f"flash_fwd_bhtd rate {rate}",
             lambda: ka.flash_fwd_bhtd(q, k, v, bias, **kw))
        o, lse = ka.flash_fwd_bhtd(q, k, v, bias, **kw)
        delta = (do * o).sum(-1).contiguous()
        bw = (q, k, v, bias, do, lse, delta)
        same(f"flash_bwd_dq_bhtd rate {rate}",
             lambda: ka.flash_bwd_dq_bhtd(*bw, **kw))
        same(f"flash_bwd_dkv_bhtd rate {rate}",
             lambda: ka.flash_bwd_dkv_bhtd(*bw, **kw))
        del q, k, v, do, bias, o, lse, delta, bw
        for dtype, t, b in (("f32", 256, None), ("f32", 256, 1),
                            ("f32", 640, 2), ("bf16", 640, 2),
                            ("bf16", 256, None)):
            x, w_qkv, w_out, g, bias = _qkv_inputs(gen, t, "pad", b=b)
            if dtype == "bf16":
                x, w_qkv, w_out, g, bias = _bf16(x, w_qkv, w_out, g, bias)
            kw = dict(n_head=h, scale=dh ** -0.5, causal=False,
                      dropout_rate=rate, dropout_seed=seed)
            plan = ka.qkv_fwd_plan(x.shape[0], t, h, ka.sm_count(x.device))
            same(f"qkv_attention_fwd {dtype} {plan} rate {rate}",
                 lambda: ka.qkv_attention_fwd(x, w_qkv, w_out, bias, **kw))
            if t == 256 and b is None:
                _, ctx, lse = ka.qkv_attention_fwd(x, w_qkv, w_out, bias,
                                                   **kw)
                same(f"qkv_bwd {dtype} rate {rate}",
                     lambda: ka.qkv_bwd(x, w_qkv, w_out, bias, g, ctx, lse,
                                        **kw))
        for dtype in (torch.float32, torch.bfloat16):
            x, res = (randn(gen, DROPOUT_ROWS, BASE["d_model"]).to(dtype)
                      for _ in range(2))
            if rate:
                same(f"dropout_add_fwd {dtype}",
                     lambda: kde.dropout_add_fwd(x, res, rate, seed))
                same(f"dropout_add_fwd no residual {dtype}",
                     lambda: kde.dropout_add_fwd(x, None, rate, seed))
                same(f"dropout_add_bwd {dtype}",
                     lambda: kde.dropout_add_bwd(x, rate, seed))
    for name, m, n, k, a_t, b_t, split in GEMM_CASES:
        a = (randn(gen, k, m).t() if a_t else randn(gen, m, k))
        b = randn(gen, n, k).t() if b_t else randn(gen, k, n)
        a, b = (x.t().contiguous().t() if t_ else x.contiguous()
                for x, t_ in ((a, a_t), (b, b_t)))
        same(f"gemm {name}", lambda: kg.gemm(a, b, split))
    for name, m, n, k, a_t, b_t, split, a_bf, b_bf, c_bf in GEMM_AMP_CASES:
        a = (randn(gen, k, m, scale=k ** -0.5).t() if a_t
             else randn(gen, m, k, scale=k ** -0.5))
        b = randn(gen, n, k).t() if b_t else randn(gen, k, n)
        a, b = (x.t().contiguous().t() if t_ else x.contiguous()
                for x, t_ in ((a, a_t), (b, b_t)))
        a = a.bfloat16() if a_bf else kg.hi_lo(a)
        b = b.bfloat16() if b_bf else kg.hi_lo(b)
        c_dtype = torch.bfloat16 if c_bf else torch.float32
        same(f"gemm_tc {name}", lambda: kg.gemm(a, b, split, c_dtype))
    x2, w2 = randn(gen, 256 * 56 * 56, 64), randn(gen, 256, 64)
    same("dot_col_stats stage-1 conv3", lambda: kc.dot_col_stats_fwd(x2, w2))
    del x2, w2
    # #18, #20 and #21 in f32 (csrc/conv_bn.cu's walk now serves bf16
    # too): the stem and C 6 for #18, every CBN_SSA_CASES mode for #20, #21
    cgen = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
    for case, shape in (CBN_STATS_CASES[0], CBN_STATS_CASES[-1]):
        y = randn_card(cgen, *shape)
        same(f"channel_stats {case}", lambda: kc.channel_stats_fwd(y))
        del y
    for case, rows, c, residual, relu in CBN_SSA_CASES:
        x, g = randn_card(cgen, rows, c), randn_card(cgen, rows, c)
        wv, bv = randn_card(cgen, c) + 1.0, randn_card(cgen, c)
        res = randn_card(cgen, rows, c) if residual else None
        same(f"ssa_fwd {case}", lambda: kc.ssa_fwd(x, wv, bv, res, relu))
        out = kc.ssa_fwd(x, wv, bv, res, relu)
        same(f"ssa_bwd {case}",
             lambda: kc.ssa_bwd(g, x, out, wv, residual, relu))
        del x, g, res, out
    return held


def build_registers(log):
    """{mangled entry function: registers} from ``-Xptxas -v`` lines."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if cur and m:
            out[cur] = int(m[1])
            cur = None
    return out


def parent_registers(log):
    """The f32 instantiations of the parent's PARENT_SOURCES against this
    tree's build: {"equal": n, "differ": [...], "unmatched": [...]}, by
    mangled name without the anonymous namespace's per-source hash.  A
    kernel whose template lost its element types, f32 being the only one
    left (#1's tiles route its T; the flash walks their T and BT, so
    ``flash_bwd_dq_kernel<Bthd, false, float, float>`` is now
    ``flash_bwd_dq_kernel<Bthd, false>``), is matched by its name and its
    other template arguments: the layout and DROP.  Under "bf16" the same
    for the bf16 instantiations, matched by name only ("unmatched" a
    count)."""
    import re

    def key(name):  # the 64-wide layouts and row_delta under older names
        name = re.sub(r"6(Bthd|Bhtd)OfILi64EE", r"4\1", name)
        name = re.sub(r"row_deltaIfLi64EE", "row_deltaIfE", name)
        return re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN_",
                      name)

    def template(name):  # kernel and template arguments, f32 types dropped
        return re.sub(r"(?<=E)f+$", "", name.split("EEv", 1)[0])

    mine = {key(n): r for n, r in build_registers(log).items()}
    by_template = {template(n): r for n, r in mine.items()}
    out = {"equal": 0, "differ": [], "unmatched": [],
           "bf16": {"equal": 0, "differ": [], "unmatched": 0}}
    for name, regs in build_registers(_PARENT.get("log", "")).items():
        name = key(name)
        if "bfloat16" in name:
            bf16, got = out["bf16"], mine.get(name)
            if got is None:
                bf16["unmatched"] += 1
            elif got == regs:
                bf16["equal"] += 1
            else:
                bf16["differ"].append((name, regs, got))
            continue
        got = mine.get(name, by_template.get(template(name)))
        if got is None:
            out["unmatched"].append(name)
        elif got == regs:
            out["equal"] += 1
        else:
            out["differ"].append((name, regs, got))
    return out


#: ResNet-50 training as the reference's ``bench_resnet50``
#: (``bench.py:425-456``): batch 256 at 224, 1000 classes, NHWC, Momentum
#: 0.1 / 0.9, ``rand`` images and ``randint(0, 1000)`` labels.  f32 with
#: TF32 off: amp (bf16) is the one cut against the bench (ROADMAP A1)
RESNET_DEPTH, RESNET_CLASSES, RESNET_SIZE = 50, 1000, 224
RESNET_BATCH, RESNET_PARITY_BATCH = 256, 16
RESNET_LR, RESNET_MOMENTUM, RESNET_TIMED_STEPS = 0.1, 0.9, 10
#: training FLOPs per image, the reference's count
#: (``bench.py`` RESNET50_TRAIN_FLOPS_PER_IMG)
RESNET_FLOPS_PER_IMAGE = 3 * 2 * 4.089e9
#: launches of one ResNet-50 step: #19 at the 32 1x1 sites of the 16
#: bottlenecks and the 4 shortcuts, #18 at the stem and the 16 3x3 sites,
#: #20 and #21 at all 53 conv + batch-norm sites
RESNET_LAUNCHES = dict(dot_col_stats=36, channel_stats=17, ssa_fwd=53,
                       ssa_bwd=53)
#: phase 2's conv + BN sites at batch 256: (label, NHWC shape) of #18's
#: input, (label, M, K, N, stride of the rows x[:, ::s, ::s, :]) of #19,
#: and (label, rows, C, residual, relu) of #20 and #21; the first of each
#: is the record in the JSON line
#: ResNet-50's bottleneck stages: (blocks, mid width, output width,
#: stride of the first block's conv1 and shortcut)
RESNET50_STAGES = ((3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
                   (3, 512, 2048, 2))


def resnet_dot_sites(batch):
    """(M, K, N) of the 36 sites #19 runs in one ResNet-50 forward at
    ``batch`` images of RESNET_SIZE: each stage's first shortcut and every
    bottleneck's conv1 (both 1x1 at the stage's stride) and conv3 (1x1)."""
    sites, side, ch = [], RESNET_SIZE // 4, 64
    for blocks, mid, out, stride in RESNET50_STAGES:
        for blk in range(blocks):
            side_out = side // (stride if blk == 0 else 1)
            m = batch * side_out ** 2
            if blk == 0:
                sites.append((m, ch, out))
            sites += [(m, ch, mid), (m, mid, out)]
            ch, side = out, side_out
    return sites


def dot_stats_bound_ms(m, k, n):
    """#19's bound at one site, as phase 2's records count it."""
    return bound(2 * m * n * k + 3 * m * n,
                 F32 * (m * k + n * k + m * n + 2 * n))[0]


CBN_STATS_CASES = (("stem 7x7", (256, 112, 112, 64)),
                   ("stage-1 3x3", (256, 56, 56, 64)),
                   ("stage-4 3x3", (256, 7, 7, 512)),
                   ("C 2 (scalar channels)", (256, 56, 56, 2)),
                   ("C 6 (scalar channels)", (256, 56, 56, 6)))
CBN_DOT_CASES = (("stage-1 conv3", 256 * 56 * 56, 64, 256, 1),
                 ("stage-4 conv3", 256 * 7 * 7, 512, 2048, 1),
                 ("stage-2 shortcut (stride 2)", 256 * 28 * 28, 256, 512,
                  2),
                 ("stage-1 conv1", 256 * 56 * 56, 64, 64, 1),
                 ("ragged M 1000 K 72 N 100", 1000, 72, 100, 1))
CBN_SSA_CASES = (("stage-1 conv3 residual relu", 256 * 56 * 56, 256, True,
                  True),
                 ("stage-1 conv1 relu", 256 * 56 * 56, 64, False, True),
                 ("stage-1 shortcut", 256 * 56 * 56, 256, False, False),
                 ("stage-4 conv3 residual relu", 256 * 7 * 7, 2048, True,
                  True),
                 ("C 2 residual relu (scalar channels)", 256 * 56 * 56, 2,
                  True, True),
                 ("C 6 (scalar channels)", 256 * 56 * 56, 6, False,
                  False))


#: phase 2's per-channel sums of #18, #19 and #21 against the same sums in
#: float64: |got - exact| <= TOL_SUM * sum of the |terms| behind each (a
#: float sum's error scales with its terms, not with its value, which a
#: zero-mean input brings near 0).  An f32 sum of k terms in a fixed order
#: strays about u * sqrt(k) / 3 of its terms' magnitude (u = 2^-24),
#: under 6e-7 for the longest serial runs here (784 partials a lane in
#: #19's stage-1 reduction); dropping one chunk of rows moves a sum by
#: about sqrt(rows in the chunk) terms (zero-mean) or by the chunk's share
#: (positive terms).  On an H100 the sound kernels read at most 4.4e-7,
#: and a dropped last chunk 2.3e-4 or more at every site
#: (chip_conv_bn_faults.py)
TOL_SUM = 2e-6


def compare_sums(name, got, exact, terms, failures):
    """Per-channel f32 sums against their float64 values: (max abs error,
    worst error over TOL_SUM's measure).  A sum out of bounds or not
    finite adds a line to ``failures``."""
    err = (got.double() - exact).abs()
    worst = (err / terms.clamp_min(1e-30)).max().item()
    if not torch.isfinite(got).all().item():
        failures.append(f"{name}: non-finite sums")
    elif worst > TOL_SUM:
        failures.append(f"{name}: error {worst} of the summed magnitudes "
                        f"over {TOL_SUM}")
    return err.max().item(), worst


def _require_same_bits(name, first, again):
    require(all(torch.equal(a, b) for a, b in zip(first, again)
                if a is not None),
            f"{name}: a repeated call gave other bits")


def randn_card(gen, *shape, scale=1.0):
    """Normal f32 numbers drawn on the card (``gen`` a CUDA generator):
    phase 2's conv + BN inputs are too large to draw on the host."""
    return torch.randn(shape, generator=gen, device="cuda") * scale


def check_conv_bn(gen):
    """#18-#21 at ResNet-50's shapes at batch 256 (CBN_*_CASES) against
    their plain twins on the card: outputs within TOL_KERNEL of the f32
    twin, per-channel sums within TOL_SUM of the twin in float64 (every
    sum is read before a sum out of bounds fails the phase); each kernel
    called twice for equal bits; #18's, #20's and #21's device-only times
    beside the parent's kernels' (``tensor_core_times``, with
    ``--parent``).  Also checks that ``conv2d_nhwc``'s output at the stem
    is NHWC-contiguous with no copy.  Returns {(name,
    case): record}; a record's ``sum_err_of_terms`` is its sums' worst
    reading against TOL_SUM."""
    from paddle_tpu_torch.kernels import conv_bn as kc

    src = "paddle_tpu_torch/csrc/conv_bn.cu"
    records, failures = {}, []
    cgen = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
    x = randn_card(cgen, 256, 224, 224, 3)
    w = randn_card(cgen, 64, 3, 7, 7, scale=0.1)
    y = kc.conv2d_nhwc(x, w, 2, 3)
    require(tuple(y.shape) == (256, 112, 112, 64) and y.is_contiguous(),
            f"conv2d_nhwc: {tuple(y.shape)} contiguous {y.is_contiguous()}"
            " (cuDNN did not keep the channels-last layout)")
    del x, w, y

    for case, shape in CBN_STATS_CASES:
        y = randn_card(cgen, *shape)
        rows, c = y.numel() // shape[-1], shape[-1]
        got = kc.channel_stats_fwd(y)
        _require_same_bits("channel_stats", got, kc.channel_stats_fwd(y))
        y64 = y.double()
        exact = kc.reference_channel_stats(y64)
        sums = [compare_sums(f"channel_stats s1 {case}", got[0], exact[0],
                             y64.abs().sum((0, 1, 2)), failures),
                compare_sums(f"channel_stats s2 {case}", got[1], exact[1],
                             exact[1], failures)]
        del y64, exact
        rec = timed_record(
            "channel_stats", src, "paddle_tpu/kernels/conv_bn.py:146",
            max(e for e, _ in sums), lambda: kc.channel_stats_fwd(y),
            lambda: kc.reference_channel_stats(y), 3 * rows * c,
            F32 * (rows * c + 2 * c),
            lambda: torch.var_mean(y, dim=(0, 1, 2)), RESNET_BATCH)
        rec["sum_err_of_terms"] = max(w for _, w in sums)
        # csrc/conv_bn.cu's walk serves bf16 too: the f32 kernel's device
        # time beside the parent's (with --parent)
        tensor_core_times(rec, lambda: kc.channel_stats_fwd(y))
        records[("channel_stats", case)] = rec
        del y

    for case, m, k, n, stride in CBN_DOT_CASES:
        if stride > 1:
            side = int(round((m // RESNET_BATCH) ** 0.5))
            full = randn_card(cgen, RESNET_BATCH, side * stride,
                              side * stride, k)
            x2 = full[:, ::stride, ::stride, :].reshape(m, k)
            copy_ms = cuda_ms(lambda: full[:, ::stride, ::stride, :]
                              .reshape(m, k))
            del full
        else:
            x2, copy_ms = randn_card(cgen, m, k), None
        w2 = randn_card(cgen, n, k, scale=k ** -0.5)
        got = kc.dot_col_stats_fwd(x2, w2)
        _require_same_bits("dot_col_stats", got, kc.dot_col_stats_fwd(x2, w2))
        want = kc.reference_dot_col_stats(x2, w2)[0]
        err = compare(f"dot_col_stats y {case}", got[0], want, TOL_KERNEL)
        del want
        # the statistics are of the stored y: the kernel's own, in float64
        y64 = got[0].double()
        exact = kc.reference_channel_stats(y64)
        sums = [compare_sums(f"dot_col_stats s1 {case}", got[1], exact[0],
                             y64.abs().sum(0), failures),
                compare_sums(f"dot_col_stats s2 {case}", got[2], exact[1],
                             exact[1], failures)]
        del got, y64, exact
        rec = timed_record(
            "dot_col_stats", src, "paddle_tpu/kernels/conv_bn.py:225",
            max([err] + [e for e, _ in sums]),
            lambda: kc.dot_col_stats_fwd(x2, w2),
            lambda: kc.reference_dot_col_stats(x2, w2),
            2 * m * n * k + 3 * m * n, F32 * (m * k + n * k + m * n + 2 * n),
            None, RESNET_BATCH)
        rec["matmul_ms"] = cuda_ms(lambda: x2 @ w2.t())
        rec["sum_err_of_terms"] = max(w for _, w in sums)
        if copy_ms is not None:
            rec["strided_copy_ms"] = copy_ms
        records[("dot_col_stats", case)] = rec
        del x2, w2

    for case, rows, c, residual, relu in CBN_SSA_CASES:
        x, g = randn_card(cgen, rows, c), randn_card(cgen, rows, c)
        wv, bv = randn_card(cgen, c) + 1.0, randn_card(cgen, c)
        res = randn_card(cgen, rows, c) if residual else None
        out = kc.ssa_fwd(x, wv, bv, res, relu)
        _require_same_bits("ssa_fwd", [out], [kc.ssa_fwd(x, wv, bv, res,
                                                         relu)])
        err_fwd = compare(f"ssa_fwd {case}", out,
                          kc.reference_ssa_fwd(x, wv, bv, res, relu),
                          TOL_KERNEL)
        got = kc.ssa_bwd(g, x, out, wv, residual, relu)
        _require_same_bits("ssa_bwd", got, kc.ssa_bwd(g, x, out, wv,
                                                      residual, relu))
        want = kc.reference_ssa_bwd(g, x, out, wv, residual, relu)
        err_bwd = max(
            compare(f"ssa_bwd dx {case}", got[0], want[0], TOL_KERNEL),
            compare(f"ssa_bwd dres {case}", got[1], want[1], TOL_KERNEL)
            if residual else 0.0)
        del want
        gm = (torch.where(out > 0, g, 0.0) if relu else g).double()  # g'
        x64 = x.double()
        sums = [compare_sums(f"ssa_bwd sg {case}", got[2], gm.sum(0),
                             gm.abs().sum(0), failures)]
        gm *= x64
        sums.append(compare_sums(f"ssa_bwd sgx {case}", got[3], gm.sum(0),
                                 gm.abs().sum(0), failures))
        del got, gm, x64
        err_bwd = max([err_bwd] + [e for e, _ in sums])
        n = rows * c
        streams = 2 + residual
        records[("ssa_fwd", case)] = timed_record(
            "ssa_fwd", src, "paddle_tpu/kernels/conv_bn.py:409", err_fwd,
            lambda: kc.ssa_fwd(x, wv, bv, res, relu),
            lambda: kc.reference_ssa_fwd(x, wv, bv, res, relu),
            (2 + residual + relu) * n, F32 * (streams * n + 2 * c), None,
            RESNET_BATCH)
        records[("ssa_bwd", case)] = timed_record(
            "ssa_bwd", src, "paddle_tpu/kernels/conv_bn.py:429", err_bwd,
            lambda: kc.ssa_bwd(g, x, out, wv, residual, relu),
            lambda: kc.reference_ssa_bwd(g, x, out, wv, residual, relu),
            (4 + relu) * n, F32 * ((3 + relu + residual) * n + 3 * c), None,
            RESNET_BATCH)
        records[("ssa_bwd", case)]["sum_err_of_terms"] = max(
            w for _, w in sums)
        tensor_core_times(records[("ssa_fwd", case)],
                          lambda: kc.ssa_fwd(x, wv, bv, res, relu))
        tensor_core_times(records[("ssa_bwd", case)],
                          lambda: kc.ssa_bwd(g, x, out, wv, residual, relu))
        del x, g, res, out
    require(not failures, "conv + BN sums out of bounds: "
            + "; ".join(failures))
    return records


#: #19 in bf16 at one site: FLOPs and bytes (bf16 x2, w2 and y, f32 sums)
def dot_stats_bf16_bound_ms(m, k, n):
    """#19 in bf16's bound at one site, as its phase-2 records count it."""
    return bound_bf16(2 * m * n * k + 3 * m * n,
                      BF16 * (m * k + n * k + m * n) + F32 * 2 * n)[0]


def _bf16_card(gen, *shape, scale=1.0):
    return randn_card(gen, *shape, scale=scale).bfloat16()


def check_conv_bn_bf16(gen):
    """#18-#21 in bf16 (amp) at CBN_*_CASES, against their plain twins on
    the card: #20's out and #21's dx and dres bit for bit (the twins'
    bf16 ops round each product and sum once, as the kernels'
    mul.rn.bf16x2 / add.rn.bf16x2 do); #19's y within one bf16 step of the
    twin's (``torch.matmul`` in bf16), its share off the float64 product
    rounded to bf16 recorded; every per-channel sum within TOL_SUM of the
    same sum in float64 over the same bf16 values (#19's over the
    kernel's own stored y, so that the epilogue is held and not the
    product's rounding).  Each kernel is called twice for equal bits.
    Each record: ms after the L2 flush and device only, the bf16 bound
    (2 B an element, FLOPs at the dense bf16 rate), and the library call
    (#18: ``torch.var_mean`` on the bf16 tensor; #19: the bare bf16
    product as ``matmul_ms``; #20 and #21 have none: the same-bytes
    ``torch.add`` / ``torch.addcmul``, labelled so).  Returns {(name,
    case): record}."""
    from paddle_tpu_torch.kernels import conv_bn as kc

    src = "paddle_tpu_torch/csrc/conv_bn.cu"
    records, failures = {}, []
    cgen = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(0, 2 ** 31, (1,), generator=gen)))

    def finish(rec, fn):
        rec.update(dtype="bf16", device_ms=cuda_ms(fn, hide_host=True))
        rec["device_bound_share"] = rec["bound_ms"] / rec["device_ms"]
        return rec

    for case, shape in CBN_STATS_CASES:
        y = _bf16_card(cgen, *shape)
        rows, c = y.numel() // shape[-1], shape[-1]
        got = kc.channel_stats_fwd(y)
        _require_same_bits("channel_stats bf16", got, kc.channel_stats_fwd(y))
        y64 = y.double()
        exact = kc.reference_channel_stats(y64)
        sums = [compare_sums(f"channel_stats bf16 s1 {case}", got[0],
                             exact[0], y64.abs().sum((0, 1, 2)), failures),
                compare_sums(f"channel_stats bf16 s2 {case}", got[1],
                             exact[1], exact[1], failures)]
        del y64, exact

        def fn():
            return kc.channel_stats_fwd(y)

        rec = timed_record(
            "channel_stats_bf16", src, "paddle_tpu/kernels/conv_bn.py:146",
            max(e for e, _ in sums), fn,
            lambda: kc.reference_channel_stats(y), 3 * rows * c,
            BF16 * rows * c + F32 * 2 * c,
            lambda: torch.var_mean(y, dim=(0, 1, 2)), RESNET_BATCH,
            bound_fn=bound_bf16)
        rec["sum_err_of_terms"] = max(w for _, w in sums)
        records[("channel_stats_bf16", case)] = finish(rec, fn)
        del y

    for case, m, k, n, stride in CBN_DOT_CASES:
        if stride > 1:
            side = int(round((m // RESNET_BATCH) ** 0.5))
            full = _bf16_card(cgen, RESNET_BATCH, side * stride,
                              side * stride, k)
            x2 = full[:, ::stride, ::stride, :].reshape(m, k)
            del full
        else:
            x2 = _bf16_card(cgen, m, k)
        w2 = _bf16_card(cgen, n, k, scale=k ** -0.5)
        got = kc.dot_col_stats_fwd(x2, w2)
        _require_same_bits("dot_col_stats bf16", got,
                           kc.dot_col_stats_fwd(x2, w2))
        require(got[0].dtype == torch.bfloat16, "dot_col_stats bf16: y is "
                f"{got[0].dtype}")
        err = compare_bf16(f"dot_col_stats bf16 y {case}", got[0],
                           kc.reference_dot_col_stats(x2, w2)[0])
        share = (got[0] != (x2.double() @ w2.double().t()).to(
            torch.bfloat16)).double().mean().item()
        # the statistics are of the stored y: the kernel's own, in float64
        y64 = got[0].double()
        exact = kc.reference_channel_stats(y64)
        sums = [compare_sums(f"dot_col_stats bf16 s1 {case}", got[1],
                             exact[0], y64.abs().sum(0), failures),
                compare_sums(f"dot_col_stats bf16 s2 {case}", got[2],
                             exact[1], exact[1], failures)]
        del got, y64, exact

        def fn():
            return kc.dot_col_stats_fwd(x2, w2)

        rec = timed_record(
            "dot_col_stats_bf16", src, "paddle_tpu/kernels/conv_bn.py:225",
            max([err] + [e for e, _ in sums]), fn,
            lambda: kc.reference_dot_col_stats(x2, w2),
            2 * m * n * k + 3 * m * n,
            BF16 * (m * k + n * k + m * n) + F32 * 2 * n, None, RESNET_BATCH,
            bound_fn=bound_bf16)
        rec.update(matmul_ms=cuda_ms(lambda: x2 @ w2.t()),
                   matmul_device_ms=cuda_ms(lambda: x2 @ w2.t(),
                                            hide_host=True),
                   off_rounding_share=share,
                   sum_err_of_terms=max(w for _, w in sums), m=m, k=k, n=n)
        records[("dot_col_stats_bf16", case)] = finish(rec, fn)
        del x2, w2

    for case, rows, c, residual, relu in CBN_SSA_CASES:
        x, g = _bf16_card(cgen, rows, c), _bf16_card(cgen, rows, c)
        wv, bv = randn_card(cgen, c) + 1.0, randn_card(cgen, c)
        res = _bf16_card(cgen, rows, c) if residual else None
        out = kc.ssa_fwd(x, wv, bv, res, relu)
        require(out.dtype == torch.bfloat16 and torch.equal(
            out, kc.ssa_fwd(x, wv, bv, res, relu)) and same_bf16_bits(
            out, kc.reference_ssa_fwd(x, wv, bv, res, relu)),
            f"ssa_fwd bf16 {case}: not the twin's bits or not repeated")
        got = kc.ssa_bwd(g, x, out, wv, residual, relu)
        _require_same_bits("ssa_bwd bf16", got, kc.ssa_bwd(g, x, out, wv,
                                                           residual, relu))
        want = kc.reference_ssa_bwd(g, x, out, wv, residual, relu)
        require(got[0].dtype == torch.bfloat16
                and same_bf16_bits(got[0], want[0])
                and (not residual or same_bf16_bits(got[1], want[1])),
                f"ssa_bwd bf16 {case}: dx or dres not the twin's bits")
        del want
        gm = (torch.where(out > 0, g, 0.0) if relu else g).double()  # g'
        x64 = x.double()
        sums = [compare_sums(f"ssa_bwd bf16 sg {case}", got[2], gm.sum(0),
                             gm.abs().sum(0), failures)]
        gm *= x64
        sums.append(compare_sums(f"ssa_bwd bf16 sgx {case}", got[3],
                                 gm.sum(0), gm.abs().sum(0), failures))
        del got, gm, x64
        n = rows * c
        streams = 2 + residual

        def fwd():
            return kc.ssa_fwd(x, wv, bv, res, relu)

        def bwd():
            return kc.ssa_bwd(g, x, out, wv, residual, relu)

        rec = timed_record(
            "ssa_fwd_bf16", src, "paddle_tpu/kernels/conv_bn.py:409", 0.0,
            fwd, lambda: kc.reference_ssa_fwd(x, wv, bv, res, relu),
            (2 + residual + relu) * n, BF16 * streams * n + F32 * 2 * c,
            None, RESNET_BATCH, bound_fn=bound_bf16)
        rec["twin_bit_equal"] = True
        if residual:
            _same_bytes(rec, lambda: torch.add(x, res), "torch.add(x, r)")
        records[("ssa_fwd_bf16", case)] = finish(rec, fwd)
        rec = timed_record(
            "ssa_bwd_bf16", src, "paddle_tpu/kernels/conv_bn.py:429",
            max(e for e, _ in sums), bwd,
            lambda: kc.reference_ssa_bwd(g, x, out, wv, residual, relu),
            (4 + relu) * n,
            BF16 * (3 + relu + residual) * n + F32 * 3 * c, None,
            RESNET_BATCH, bound_fn=bound_bf16)
        rec.update(twin_bit_equal=True,
                   sum_err_of_terms=max(w for _, w in sums))
        if residual and relu:
            _same_bytes(rec, lambda: torch.addcmul(g, x, out),
                        "torch.addcmul(g, x, out)",
                        note="4 of the kernel's 5 streams (its 3 reads, 1 "
                        "of its 2 writes), not the same function")
        records[("ssa_bwd_bf16", case)] = finish(rec, bwd)
        del x, g, res, out
    require(not failures, "conv + BN bf16 sums out of bounds: "
            + "; ".join(failures))
    return records


def check_conv_bn_refusals(gen):
    """No fallback: on CUDA tensors each conv + BN wrapper raises, before
    any launch and without running its twin, on a shape or a mix of types
    its kernel cannot take: #19 in bf16 at K % 8 != 0 and at an odd N, bf16
    activations beside an f32 operand or residual, bf16 (not f32) wv, fp16
    activations.  Returns the refused calls' names."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import conv_bn as kc

    cgen = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
    x, w2 = _bf16_card(cgen, 256, 64), _bf16_card(cgen, 32, 64)
    wv, bv = randn_card(cgen, 64) + 1.0, randn_card(cgen, 64)
    calls = (
        ("dot_col_stats bf16 K 60", lambda: kc.dot_col_stats_fwd(
            _bf16_card(cgen, 256, 60), _bf16_card(cgen, 32, 60))),
        ("dot_col_stats bf16 N 33", lambda: kc.dot_col_stats_fwd(
            x, _bf16_card(cgen, 33, 64))),
        ("dot_col_stats bf16 x2, f32 w2", lambda: kc.dot_col_stats_fwd(
            x, w2.float())),
        ("ssa_fwd bf16 x, f32 residual", lambda: kc.ssa_fwd(
            x, wv, bv, x.float(), True)),
        ("ssa_fwd bf16 wv", lambda: kc.ssa_fwd(x, wv.bfloat16(), bv)),
        ("ssa_bwd f32 g, bf16 x", lambda: kc.ssa_bwd(
            x.float(), x, x, wv, False, True)),
        ("channel_stats fp16", lambda: kc.channel_stats_fwd(x.half())))
    before, refused = dict(kernels.launches), []
    for what, call in calls:
        try:
            call()
        except ValueError:
            refused.append(what)
            continue
        require(False, f"{what}: ran instead of raising")
    torch.cuda.synchronize()
    require(kernels.launches == before, "a refused conv + BN call launched")
    return refused


# -- #22 and #23: the multi-table embedding kernels of DeepFM ---------------

#: the device of phase 2's embedding checks and phase 3 (h) (a rehearsal
#: on the CPU sets it to "cpu")
DEV = "cuda"


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device=DEV) * scale

#: DeepFM at ``bench_deepfm``'s defaults (``paddle_tpu/models/deepfm.py``,
#: ``bench.py``): 26 slots, tables of 1000001 rows, embedding width 10
#: (and the first-order width 1), batch 4096, lazy Adam at 1e-3
DEEPFM_HASH, DEEPFM_BATCH, DEEPFM_EMB, DEEPFM_LR = 1000001, 4096, 10, 1e-3
DEEPFM_SLOTS = 26
#: the two table groups: (name, width)
DEEPFM_GROUPS = (("emb", DEEPFM_EMB), ("w1", 1))
#: #23 against its twin, relative per element: both sum each id's rows in
#: the stable order and round every product and sum on its own, so they
#: should agree to the bit; 1e-6 leaves room for one rounding apart
TOL_APPLY = 1e-6
#: ids of phase 2's apply checks: rows 100-104 repeat row 0's id (a run of
#: 5), rows 200-249 row 1's (50), the last 64 rows hold the sentinel V
APPLY_RUNS, APPLY_SENTINELS = ((0, 100, 5), (1, 200, 50)), 64
#: the skewed id mix: numpy zipf draws of this exponent, less 1, mod V (the
#: longest run of a slot of 4096 is a few hundred ids)
ZIPF_A = 1.1


def _deepfm_ids(b, hash_dim, seed):
    """[26, b] int32 ids on the card, uniform in [0, hash_dim) as
    ``make_batch`` draws them (numpy, seeded)."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, hash_dim, (DEEPFM_SLOTS, b))
                            .astype(np.int32)).to(DEV)


def _apply_ids(b, hash_dim, seed):
    """:func:`_deepfm_ids` with APPLY_RUNS of equal ids planted in every
    slot and the APPLY_SENTINELS last ids set to the sentinel hash_dim."""
    ids = _deepfm_ids(b, hash_dim, seed)
    for src, at, n in APPLY_RUNS:
        ids[:, at:at + n] = ids[:, src:src + 1]
    ids[:, b - APPLY_SENTINELS:] = hash_dim
    return ids


def _zipf_ids(b, hash_dim, seed):
    """[26, b] int32 ids on the card, skewed as CTR ids are: numpy
    ``zipf(ZIPF_A)`` draws less 1, mod hash_dim (seeded)."""
    rng = np.random.RandomState(seed)
    ids = (rng.zipf(ZIPF_A, (DEEPFM_SLOTS, b)) - 1) % hash_dim
    return torch.from_numpy(ids.astype(np.int32)).to(DEV)


#: #23's id mixes: (i) the main path's uniform ids, (ii) phase 2's planted
#: runs and sentinels (the check's own mix), (iii) the skewed draw
APPLY_MIXES = {"uniform": _deepfm_ids, "planted": _apply_ids,
               "zipf": _zipf_ids}


def touched_sectors(ids, d, height):
    """32-byte sectors of the [height, d] f32 tables that the rows at ids
    [S, K] span, counted once per table (a row two ids share is read
    once); ids outside [0, height) touch none."""
    s_n = ids.shape[0]
    ok = (ids >= 0) & (ids < height)
    first = ids.long() * d * F32 // 32
    last = (ids.long() * d * F32 + d * F32 - 1) // 32
    per_table = (height * d * F32) // 32 + 2
    slot = torch.arange(s_n, device=ids.device)[:, None] * per_table
    keys = torch.cat([(first + slot)[ok], (last + slot)[ok]])
    return int(torch.unique(keys).numel())


def unique_rows(ids, height):
    """Distinct (slot, id) pairs of ids [S, K] inside [0, height)."""
    ok = (ids >= 0) & (ids < height)
    slot = torch.arange(ids.shape[0], device=ids.device)[:, None] * height
    return int(torch.unique((ids.long() + slot)[ok]).numel())


def _rel_close(name, got, want, tol):
    """max |got - want| / |want| over the elements; raises above tol
    (elements equal on both sides, zeros included, pass)."""
    err = (got - want).abs()
    worst = (err / want.abs().clamp_min(1e-30)).masked_fill(err == 0, 0.0)
    worst = worst.max().item()
    require(torch.isfinite(got).all().item() and worst <= tol,
            f"{name}: relative error {worst} over {tol}")
    return worst


def _device_only(r, fn):
    """A small kernel's record: ``ms`` (and the bound share) becomes the
    device time of one wrapper call (``cuda_ms(hide_host=True)``), and
    ``call_ms`` keeps the time with the device's wait for the host's
    enqueue in it, which at these sizes is most of a call."""
    r["call_ms"] = r["ms"]
    r["ms"] = cuda_ms(fn, hide_host=True)
    r["bound_share"] = r["bound_ms"] / r["ms"]


#: torch.optim.SparseAdam (#23's library yardstick) against the twin, each
#: tensor's largest difference over its largest magnitude: the same lazy
#: Adam, with the rate on the host and duplicates summed by coalesce()
TOL_LIBRARY_ADAM = 1e-5


def library_sparse_adam(tables, ids, rows, consts):
    """#23's library yardstick: one ``torch.optim.SparseAdam.step()`` over
    copies of the group's tables, with each table's rows at its ids (those
    inside [0, V)) as an uncoalesced sparse gradient.  Its first step from
    zero moments is held against the twin's with lr_t = lr sqrt(1 - b2) /
    (1 - b1): each tensor's difference beyond one rounding of its value
    within TOL_LIBRARY_ADAM of its largest change.  Then one step() is
    timed.  The port never calls it.  Returns (ms, the worst relative
    difference)."""
    from paddle_tpu_torch.kernels import embedding as ke

    b1, b2, eps = consts
    v, d = tables[0].shape
    params = [torch.nn.Parameter(t.clone()) for t in tables]
    for p, i, r in zip(params, ids, rows):
        ok = (i >= 0) & (i < v)
        p.grad = torch.sparse_coo_tensor(i[ok].long()[None], r[ok], (v, d),
                                         check_invariants=True)
    opt = torch.optim.SparseAdam(params, lr=DEEPFM_LR, betas=(b1, b2),
                                 eps=eps)
    opt.step()
    twin = [[t.clone() for t in tables],
            [torch.zeros_like(t) for t in tables],
            [torch.zeros_like(t) for t in tables]]
    lr_t = torch.tensor([DEEPFM_LR * (1 - b2) ** 0.5 / (1 - b1)], device=DEV)
    ke.reference_sparse_adam(*twin, ids, rows, lr_t, *consts)
    worst = (0.0, "")
    with torch.no_grad():
        for k, (p, t0) in enumerate(zip(params, tables)):
            st = opt.state[p]
            for kind, got, want, base in (
                    ("param", p, twin[0][k], t0),
                    ("m1", st["exp_avg"], twin[1][k], 0.0),
                    ("m2", st["exp_avg_sq"], twin[2][k], 0.0)):
                # beyond the one rounding of the sum base + change
                mag = want.abs()
                ulp = torch.nextafter(mag, torch.full_like(mag, math.inf))
                ulp -= mag
                off = ((got - want).abs() - ulp).clamp_min(0).max().item()
                scale = (want - base).abs().max().item()
                worst = max(worst, (off / max(scale, 1e-30), f"{kind} {k}"))
    require(worst[0] <= TOL_LIBRARY_ADAM, f"torch.optim.SparseAdam: table "
            f"{worst[1]} off the twin by {worst[0]} of its largest change")
    del twin
    return cuda_ms(opt.step), worst[0]


#: the keys of a #22 or #23 case carried in its kernel's JSON record
TABLE_CASE_KEYS = ("batch", "ms", "call_ms", "plain_ms", "bound_ms",
                   "bound_share", "sort_ms", "run_max", "twin_bit_equal")


def _apply_record(mode, group, d, mix, ids, tables, state, call, twin,
                  flops, nbytes, b):
    """One #23 case: ``call(kinds)`` (the kernel) on two copies of the
    group's ``state`` (the tables, and the moments in Adam mode) against
    ``twin(kinds)`` on a third: equal bits to the twin (TOL_APPLY's
    relative error reported) and to each other; then timed after the L2
    flush beside the twin, device only and with the host's enqueue, and
    beside a stable ``torch.sort`` of the same ids (what the launch's
    sort phase replaced)."""
    def clones():
        return [[t.clone() for t in kind] for kind in state]

    runs = []
    for _ in range(2):
        kinds = clones()
        call(kinds)
        runs.append(kinds)
    want = clones()
    twin(want)
    torch.cuda.synchronize()
    label = f"multi_table_apply {mode} {group} {mix}"
    err = max(_rel_close(f"{label} {i}", g, w, TOL_APPLY)
              for gk, wk in zip(runs[0], want) for i, (g, w) in
              enumerate(zip(gk, wk)))
    _require_same_bits(label, [t for kind in runs[0] for t in kind],
                       [t for kind in runs[1] for t in kind])
    bit_equal = all(torch.equal(g, w) for gk, wk in zip(runs[0], want)
                    for g, w in zip(gk, wk))
    require(bit_equal, f"{label}: not the twin's bits")
    del runs, want
    v = tables[0].shape[0]
    r = timed_record(
        "multi_table_apply", "paddle_tpu_torch/csrc/embedding.cu",
        "paddle_tpu/kernels/embedding.py:343", err, lambda: call(state),
        lambda: twin(state), flops, nbytes, None, b)
    _device_only(r, lambda: call(state))
    ok = (ids >= 0) & (ids < v)
    r.update(mode=mode, group=f"{group} [{len(tables)} x {v} x {d}]",
             mix=mix, twin_bit_equal=bit_equal,
             sort_ms=cuda_ms(lambda: torch.sort(ids, dim=1, stable=True),
                             hide_host=True),
             run_max=max(int(torch.unique(i[k], return_counts=True)[1]
                             .max()) if k.any() else 0
                         for i, k in zip(ids, ok)))
    return r


def check_embedding():
    """#22 and #23 at DeepFM's shapes against their twins on the card.
    #22 on both groups, and on the width-10 tables with the ids mod
    DEEPFM_SMOKE_HASH (the same rows over a 100x smaller span): equal
    bits.  #23 in Adam mode on both groups and in SGD and scatter-add
    modes on the first, at each of APPLY_MIXES (the check's own planted
    runs first, then the main path's uniform ids and the skewed draw):
    params and moments equal to the twin's bits, and a repeat on the same
    inputs equal to the bit.  Each is timed after an L2 flush beside its
    plain twin, device only and with the host's enqueue; #22 also beside
    26 ``F.embedding`` calls (no one library call does a group), #23
    beside a stable ``torch.sort`` of its ids and, in Adam mode on the
    width-10 group's planted mix, beside ``torch.optim.SparseAdam``
    (:func:`library_sparse_adam`).  Returns [(record, label)]; the first
    record of each kernel carries the others' numbers under ``cases``."""
    import torch.nn.functional as Fn

    from paddle_tpu_torch.kernels import embedding as ke

    gen = torch.Generator(device=DEV).manual_seed(22)
    out = []
    v, s_n, b = DEEPFM_HASH, DEEPFM_SLOTS, DEEPFM_BATCH
    for group, d in DEEPFM_GROUPS:
        tables = [_randn(gen, v, d, scale=0.01) for _ in range(s_n)]
        ids = _deepfm_ids(b, v, seed=len(out))
        for span, gids in (("", ids), (f" hash {DEEPFM_SMOKE_HASH}",
                                       ids % DEEPFM_SMOKE_HASH)):
            got = ke.multi_table_gather(tables, gids)
            want = ke.reference_multi_table_gather(tables, gids)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"multi_table_gather {group}{span}: not the twin's bits")
            _require_same_bits(f"multi_table_gather {group}{span}", [got],
                               [ke.multi_table_gather(tables, gids)])
            long_ids = [i.long() for i in gids]
            nbytes = (F32 * s_n * b * (1 + d)
                      + 32 * touched_sectors(gids, d, v))
            r = timed_record(
                "multi_table_gather", "paddle_tpu_torch/csrc/embedding.cu",
                "paddle_tpu/kernels/embedding.py:229", 0.0,
                lambda: ke.multi_table_gather(tables, gids),
                lambda: ke.reference_multi_table_gather(tables, gids), 0,
                nbytes, None, b)
            r["embedding_x26_ms"] = cuda_ms(lambda: [
                Fn.embedding(i, t) for i, t in zip(long_ids, tables)],
                hide_host=True)
            _device_only(r, lambda: ke.multi_table_gather(tables, gids))
            r["group"] = f"{group} [{s_n} x {v} x {d}]{span}"
            out.append((r, f" {r['group']} b={b}"))

        # #23 on this group, at each id mix
        rows = _randn(gen, s_n, b, d, scale=0.1)
        m1s = [_randn(gen, v, d, scale=0.01) for _ in range(s_n)]
        m2s = [_randn(gen, v, d, scale=0.01).square() for _ in range(s_n)]
        lr_t = torch.tensor([DEEPFM_LR * 0.5], device=DEV)
        consts = (0.9, 0.999, 1e-8)
        seed = 10 + len(out) - 1
        for mix in ("planted", "uniform", "zipf"):
            ids = APPLY_MIXES[mix](b, v, seed=seed)
            sectors = touched_sectors(ids, d, v)
            uniq = unique_rows(ids, v)
            r = _apply_record(
                "adam", group, d, mix, ids, tables, [tables, m1s, m2s],
                lambda k: ke.multi_table_sparse_adam(*k, ids, rows, lr_t,
                                                     *consts),
                lambda k: ke.reference_sparse_adam(*k, ids, rows, lr_t,
                                                   *consts),
                12 * uniq * d, F32 * s_n * b * (1 + d) + 32 * sectors * 6, b)
            if d > 1 and mix == "planted":
                r["library_ms"], r["library_max_abs_err"] = \
                    library_sparse_adam(tables, ids, rows, consts)
            out.append((r, f" adam {r['group']} b={b} {mix} ids"))
            if d == 1:
                continue
            for mode, scale in (("sgd", -DEEPFM_LR), ("scatter_add", 1.0)):
                r = _apply_record(
                    mode, group, d, mix, ids, tables, [tables],
                    lambda k: ke.multi_table_scatter_add(k[0], ids, rows,
                                                         scale),
                    lambda k: ke.reference_scatter_add(k[0], ids, rows,
                                                       scale),
                    2 * uniq * d,
                    F32 * s_n * b * (1 + d) + 32 * sectors * 2, b)
                out.append((r, f" {mode} {r['group']} b={b} {mix} ids"))
        del m1s, m2s, rows
    for name in ("multi_table_gather", "multi_table_apply"):
        mine = [r for r, _ in out if r["name"] == name]
        mine[0]["cases"] = {
            " ".join(str(r[k]) for k in ("mode", "group", "mix") if k in r):
            {k: r[k] for k in TABLE_CASE_KEYS if k in r} for r in mine[1:]}
    return out


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------


def source_batch(b, seed):
    """Token ids [b, 256] in [2, vocab) with padded tails (pad id 0); row
    0 of a batch is unpadded."""
    rng = np.random.RandomState(seed)
    src = rng.randint(2, BASE["src_vocab_size"], (b, SRC_LEN))
    lens = rng.randint(SRC_LEN // 2, SRC_LEN + 1, b)
    lens[0] = SRC_LEN if b > 1 else 200
    src[np.arange(SRC_LEN)[None, :] >= lens[:, None]] = 0
    return src.astype(np.int64)


def expected(**counts):
    """The launch counters as a path must leave them: ``counts``, every
    other kernel 0."""
    from paddle_tpu_torch import kernels

    return {name: counts.get(name, 0) for name in kernels.launches}


def run_main_path(model, cpu_model, b, cfg=BASE):
    """The ring cache's fused route at ``cfg``'s widths, counted; with a
    ``cpu_model``, the plain path on the CPU teacher-forced on its tokens
    (cross cache and every step's logits).  Then timed."""
    from paddle_tpu_torch import GenerationSession
    from paddle_tpu_torch import kernels

    L = cfg["n_layer"]
    sfx = kernels.width_suffix(cfg["d_key"])
    qkv, mega = "qkv_attention_fwd" + sfx, "megastep" + sfx
    src = source_batch(b, seed=b)
    # eos outside the vocabulary: every lane generates all 64 tokens, the
    # fixed work bench.py's bench_decode also uses
    sess_kw = dict(batch_size=b, src_seq_len=SRC_LEN, max_out_len=MAX_OUT,
                   bos_id=0, eos_id=-1)

    # -- the counted run --------------------------------------------------
    sess = GenerationSession(model, **sess_kw)
    kernels.reset_launches()
    sess.prefill(src)
    require(kernels.launches == expected(**{qkv: L}),
            f"b={b}: prefill launches {kernels.launches}")
    tokens, logits = [], []
    for _ in range(MAX_OUT):
        tokens.append(sess.decode_step())
        logits.append(sess.last_logits.clone())
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts == expected(**{qkv: L, mega: L * MAX_OUT},
                               ffn=L * MAX_OUT),
            f"b={b}: main-path launches {counts}")
    tokens = np.stack(tokens, axis=1)
    require(tokens.shape == (b, MAX_OUT), f"tokens {tokens.shape}")
    require(((tokens >= 0) & (tokens < cfg["trg_vocab_size"])).all(),
            "token out of range")
    route = "ring fused" + (f" d_head {cfg['d_key']}" if sfx else "")
    max_err = decided = total = None
    if cpu_model is not None:
        # -- the plain path on the CPU, teacher-forced --------------------
        plain = GenerationSession(cpu_model, **sess_kw)
        plain.prefill(src)
        for name in ("k", "v", "lengths"):
            compare(f"b={b} cross cache {name}",
                    getattr(sess.cross_cache, name).cpu(),
                    getattr(plain.cross_cache, name), TOL_E2E)
        max_err, decided, total = 0.0, 0, b * MAX_OUT
        prev = np.zeros(b, np.int64)  # BOS
        for step in range(MAX_OUT):
            plain.last_tok.copy_(torch.from_numpy(prev))
            plain.decode_step()
            want = plain.last_logits
            got = logits[step].cpu()
            max_err = max(max_err, compare(f"b={b} step {step} logits", got,
                                           want, TOL_E2E))
            decided += argmax_held(b, step, tokens[:, step], want)
            prev = tokens[:, step]

    run = dict(batch=b, route=route, launches=counts,
               logits_max_abs_err=max_err, argmax_checked=decided,
               argmax_total=total)
    run.update(time_session(GenerationSession(model, **sess_kw), src))
    return run, tokens, logits


def time_session(timed, src):
    """Prefill time (median of 5 after an untimed one) and the decode
    rate and step times over MAX_OUT steps, host clock; every call returns
    to the host, so each is synchronous."""
    timed.prefill(src)  # set-up: the allocator grows to this batch
    prefill_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed.prefill(src)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = []
    t1 = time.perf_counter()
    for _ in range(MAX_OUT):
        t = time.perf_counter()
        timed.decode_step()
        step_ms.append((time.perf_counter() - t) * 1e3)
    decode_s = time.perf_counter() - t1
    b = timed.batch_size
    return dict(prefill_ms=float(np.median(prefill_ms)),
                prefill_ms_range=(min(prefill_ms), max(prefill_ms)),
                decode_tokens_per_s=b * MAX_OUT / decode_s,
                decode_ms_per_step=decode_s / MAX_OUT * 1e3,
                # 64 steps: the 80th percentile has 12 samples beyond it
                step_ms_p50=float(np.percentile(step_ms, 50)),
                step_ms_p80=float(np.percentile(step_ms, 80)))


def argmax_held(b, step, tokens, logits):
    """Raise unless tokens [b] (host) are the argmax of logits [b, V]
    wherever the top-2 gap clears twice TOL_E2E; returns how many lanes
    cleared it."""
    top2 = logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    clear = (gap > 2 * TOL_E2E * (1 + top2[:, 0].abs())).cpu()
    same = torch.from_numpy(np.asarray(tokens)) == logits.argmax(-1).cpu()
    require(bool(same[clear].all()),
            f"b={b} step {step}: argmax differs on a clear margin")
    return int(clear.sum())


def run_route(model, b, src, ref_tokens, ref_logits, expect, route,
              **sess_kw):
    """Phase 3 (a)/(b): one route teacher-forced on the main path's tokens
    (ref_tokens [b, MAX_OUT] host, ref_logits per step on the card); its
    logits must agree with the main path's within TOL_E2E and its launch
    counts must read ``expect``.  Then timed free-running."""
    from paddle_tpu_torch import GenerationSession
    from paddle_tpu_torch import kernels

    kw = dict(batch_size=b, src_seq_len=SRC_LEN, max_out_len=MAX_OUT,
              bos_id=0, eos_id=-1, **sess_kw)
    sess = GenerationSession(model, **kw)
    forced = torch.from_numpy(ref_tokens).cuda()
    kernels.reset_launches()
    sess.prefill(src)
    max_err, decided = 0.0, 0
    for step in range(MAX_OUT):
        if step:
            sess.last_tok.copy_(forced[:, step - 1])
        sess.decode_step()
        max_err = max(max_err, compare(
            f"{route} b={b} step {step} logits", sess.last_logits,
            ref_logits[step], TOL_E2E))
        decided += argmax_held(b, step, ref_tokens[:, step],
                               sess.last_logits)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts == expect, f"{route} b={b}: launches {counts}")
    run = dict(batch=b, route=route, launches=counts,
               logits_max_abs_err=max_err, argmax_checked=decided,
               argmax_total=b * MAX_OUT)
    run.update(time_session(GenerationSession(model, **kw), src))
    return run


#: phase 3 (c): 64 slots; 160 requests from 16 client threads, one every
#: 5 ms; paged pools of 256 blocks a side (393,216 B each, 100 MB a pool:
#: half the self pool's ring-equivalent 512 blocks and a quarter of the
#: cross pool's 1024, so the cross budget binds and holds requests back)
SERVE_SLOTS, SERVE_REQUESTS, SERVE_CLIENTS = 64, 160, 16
SERVE_BLOCKS, ARRIVAL_GAP_S, SERVE_WAIT_S = 256, 0.005, 300.0
#: resubmissions of a shed request (after its retry_after_s)
SERVE_RETRIES = 3


def serving_traffic(seed=0, n=SERVE_REQUESTS):
    """(prompts, max_tokens) of ``n`` requests: prompt lengths uniform in
    8-256 with ids in [2, vocab), max_tokens uniform in 8-64; requests 0,
    5, 10, ... carry 4 shared prompts, 8 consecutive ones each (requests
    0-35 the first, 40-75 the second, ...)."""
    rng = np.random.RandomState(seed)
    vocab = BASE["src_vocab_size"]

    def prompt():
        return rng.randint(2, vocab, rng.randint(8, SRC_LEN + 1)).tolist()

    prompts = [prompt() for _ in range(n)]
    max_tokens = rng.randint(8, MAX_OUT + 1, n).tolist()
    shared = [prompt() for _ in range(4)]
    for j, m in enumerate(range(0, n, 5)):
        prompts[m] = shared[j // 8 % 4]
    return prompts, max_tokens


def run_serving(model, paged, cfg=BASE, requests=SERVE_REQUESTS,
                blocks=SERVE_BLOCKS):
    """Phase 3 (c) (and (m) at ``cfg``'s widths): the batcher on one cache
    layout under the traffic above, ``requests`` of them, paged pools of
    ``blocks`` blocks a side.  Returns (stats, results, prompts)."""
    import threading

    from paddle_tpu_torch import GenerationSession, kernels
    from paddle_tpu_torch.serving import (ContinuousBatcher,
                                          GenerationConfig,
                                          GenerationServingModel,
                                          Overloaded)

    sfx = kernels.width_suffix(cfg["d_key"])
    name = ("paged" if paged else "ring") + sfx
    L = cfg["n_layer"]
    sess = GenerationSession(model, SERVE_SLOTS, SRC_LEN, MAX_OUT, bos_id=0,
                             eos_id=-1, paged=paged,
                             num_blocks=blocks if paged else 0)
    served = GenerationServingModel(
        GenerationConfig(name, slots=SERVE_SLOTS, max_tokens=MAX_OUT),
        session=sess)
    served.warmup()
    batcher = ContinuousBatcher(served)
    prompts, max_tokens = serving_traffic(n=requests)
    results = [None] * requests
    errors, shed = [], []

    def one(n):
        # a shed request (Overloaded) waits its retry_after_s and is
        # submitted again, at most SERVE_RETRIES times
        for attempt in range(SERVE_RETRIES + 1):
            try:
                results[n] = batcher.submit(
                    prompts[n], max_tokens=max_tokens[n],
                    timeout=SERVE_WAIT_S)
                return
            except Overloaded as exc:
                shed.append(n)
                if attempt == SERVE_RETRIES:
                    errors.append((n, repr(exc)))
                    return
                time.sleep(exc.retry_after_s)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append((n, repr(exc)))
                return

    def client(c, t0):
        # open-loop arrivals: request n is submitted at t0 + n * gap
        workers = []
        for n in range(c, requests, SERVE_CLIENTS):
            delay = t0 + n * ARRIVAL_GAP_S - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            workers.append(threading.Thread(target=one, args=(n,)))
            workers[-1].start()
        for w in workers:
            w.join(timeout=SERVE_WAIT_S)

    kernels.reset_launches()
    batcher.start()
    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c, t0))
                   for c in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=SERVE_WAIT_S)
        wall_s = time.perf_counter() - t0
        drained = batcher.drain(timeout=60.0)
    finally:
        batcher.stop(timeout=60.0)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(not errors, f"serving {name}: failed requests {errors[:4]}")
    require(drained, f"serving {name}: batcher did not drain")
    for n, res in enumerate(results):
        require(res is not None and len(res[0]) == max_tokens[n],
                f"serving {name}: request {n} got "
                f"{None if res is None else len(res[0])} of "
                f"{max_tokens[n]} tokens")
    c = batcher.counters
    prefills = c[f"serving.gen.{name}.prefills"]
    hits = c[f"generation.{name}.prefix_hits_total"]
    steps = c[f"serving.gen.{name}.decode_steps"]
    tokens = sum(max_tokens)
    require(c[f"serving.gen.{name}.tokens"] == tokens,
            f"serving {name}: token counter {c[f'serving.gen.{name}.tokens']}")
    if paged:
        # every request either led its prompt's registry entry (one
        # prefill) or shared a registered one (no prefill)
        require(prefills + hits == requests and hits > 0,
                f"serving paged: prefills {prefills} + hits {hits}")
        require(c[f"generation.{name}.admission_holds_total"] > 0,
                "serving paged: the block budget never held a request")
        require(sess.self_cache.allocator.used_count == 0
                and sess.cross_cache.allocator.used_count == 0
                and not batcher._prefix_map,
                "serving paged: pools or prefix registry not drained")
        mega = {"megastep_paged" + sfx: L * steps}
    else:
        require(prefills == requests and hits == 0,
                f"serving ring: prefills {prefills}, hits {hits}")
        mega = {"megastep" + sfx: L * steps}
    qkv = counts["qkv_attention_fwd" + sfx]
    require(qkv > 0 and qkv % L == 0
            and counts == expected(**{"qkv_attention_fwd" + sfx: qkv},
                                   ffn=L * steps, **mega),
            f"serving {name}: launches {counts}")
    ttft = [res[1]["ttft_ms"] for res in results]
    stats = dict(
        route=f"serving {name}", launches=counts, wall_s=wall_s,
        shed=len(shed), retries=len(shed) - sum(
            1 for _, e in errors if "Overloaded" in e),
        requests=requests, requests_per_s=requests / wall_s,
        generated_tokens_per_s=tokens / wall_s, tokens=tokens,
        ttft_ms_p50=float(np.percentile(ttft, 50)),
        ttft_ms_p90=float(np.percentile(ttft, 90)),
        occupancy_peak=c[f"serving.gen.{name}.occupancy_peak"],
        decode_steps=steps, prefills=prefills, prefix_hits=hits,
        blocks_used_peak=(c[f"generation.{name}.blocks_used_peak"]
                          if paged else None),
        admission_holds=(c[f"generation.{name}.admission_holds_total"]
                         if paged else None),
        blocks_total=(2 * (blocks - 1) if paged else None),
        kv_cache_bytes=served.kv_cache_bytes)
    return stats, results, prompts


#: phase 3 (m): requests to the batcher at BIG's widths (64 slots, paged
#: pools of 128 blocks a side: 201 MB a pool, the budget binds)
HEAD128_SERVE_REQUESTS, HEAD128_SERVE_BLOCKS = 48, 128


def run_head128(big):
    """Phase 3 (m): serving at head width 128 (C2 part 1) on BIG's widths
    (Transformer-big's, 8 heads of 128, 6 + 6 layers, seeded weights
    ``big``).  At b=1 and b=64: the ring cache's fused route counted
    (#1 at 128 L a prefill, #10 at 128 and #11 L a token), at b=1 held
    against the CPU's plain path over all MAX_OUT tokens (teacher-forced,
    TOL_E2E); the ring unfused (#14 at 128, 2 L a token), paged unfused
    (#15 at 128) and paged fused (#12 at 128 and #13) routes teacher-forced
    on its tokens, their logits within TOL_E2E of its logits on the card;
    each timed (prefill ms, decode tokens/s).  Then the batcher on paged
    pools (64 slots, HEAD128_SERVE_REQUESTS requests), a sample of its
    requests replayed on a batch-1 session (:func:`check_sampled`).  No
    composition anywhere.  Returns (runs, serving stats)."""
    from paddle_tpu_torch import Transformer, kernels

    L = BIG["n_layer"]
    cpu_big = Transformer(**BIG, device="cpu")
    cpu_big.load_state_dict(big.state_dict())
    unfused = Transformer(**BIG, fused_decode_step=False)
    unfused.load_state_dict(big.state_dict())
    runs = []
    kernels.reset_launches()
    for b in BATCHES:
        run, tokens, logits = run_main_path(
            big, cpu_big if b == 1 else None, b, BIG)
        runs.append(run)
        src = source_batch(b, seed=b)
        for paged in (False, True):
            walk = "flash_decode_paged" if paged else "flash_decode"
            runs.append(run_route(
                unfused, b, src, tokens, logits,
                expected(qkv_attention_fwd_dh128=L,
                         **{walk + "_dh128": 2 * L * MAX_OUT}),
                f"{'paged' if paged else 'ring'} unfused d_head 128",
                paged=paged))
        runs.append(run_route(
            big, b, src, tokens, logits,
            expected(qkv_attention_fwd_dh128=L,
                     megastep_paged_dh128=L * MAX_OUT, ffn=L * MAX_OUT),
            "paged fused d_head 128", paged=True))
        del logits
        torch.cuda.synchronize()
    require(not any(kernels.composed.values()),
            f"head width 128: composed {kernels.composed}")
    del cpu_big, unfused
    stats, results, prompts = run_serving(big, True, BIG,
                                          HEAD128_SERVE_REQUESTS,
                                          HEAD128_SERVE_BLOCKS)
    stats["sampled_argmax"] = check_sampled(big, prompts, results)
    require(not any(kernels.composed.values()),
            f"head width 128 serving: composed {kernels.composed}")
    return runs, stats


def check_sampled(model, prompts, results):
    """Served requests (one whole sharer group, 0-35, and up to 8 others)
    replayed on a batch-1 ring session on the card, teacher-forced on the
    batcher's tokens: the argmax must agree wherever the top-2 gap is
    clear.  Returns (steps cleared, steps checked)."""
    from paddle_tpu_torch import GenerationSession

    group = list(range(0, 40, 5))
    others = [n for n in range(len(results)) if n % 5][::16][:8]
    sess = GenerationSession(model, 1, SRC_LEN, MAX_OUT, bos_id=0,
                             eos_id=-1)
    decided = total = 0
    for n in group + others:
        tokens = results[n][0]
        src = np.zeros((1, SRC_LEN), np.int64)
        src[0, :len(prompts[n])] = prompts[n]
        sess.prefill(src)
        for step, tok in enumerate(tokens):
            if step:
                sess.last_tok.fill_(tokens[step - 1])
            sess.decode_step()
            decided += argmax_held(1, step, [tok], sess.last_logits)
            total += 1
    return decided, total


#: phase 3 (d): per-step loss of the card against the CPU's plain path
#: (f32, TF32 off), relative
TOL_TRAIN_LOSS = 1e-4
#: step 1's gradient, per parameter tensor, ||g - g64|| / ||g64|| against a
#: float64 evaluation of the same step on the CPU: the card must be within
#: 1e-4 of it, or no further than twice the CPU's own f32 gradient is.  At
#: length 256, 12 layers deep, f32 itself is off float64 by more than 1e-4
#: for most tensors (this phase prints both): the softmax backward's
#: dp - delta and the layer norms' backward cancel, so two f32 orders of
#: summation differ by that much and 1e-4 between them is out of reach.
TOL_TRAIN_GRAD = 1e-4
TRAIN_LR, TRAIN_PARITY_STEPS, TRAIN_TIMED_STEPS = 1e-4, 2, 10
#: f32 FLOPs per step per launch site: 6 encoder self, 6 decoder self and
#: 6 cross-attention calls of each bthd kernel
TRAIN_SITES = 3 * BASE["n_layer"]


def transformer_train_flops_per_token(n_layer, d_model, d_ff, n_head, d_key,
                                      seq_len, vocab):
    """Analytic matmul FLOPs per token, fwd, for the enc+dec transformer
    (matmuls only; 2 FLOPs per MAC).  Train = 3x fwd (bwd ~= 2x fwd).
    Copied from the reference's ``bench.py``."""
    dh = n_head * d_key
    attn = 4 * d_model * dh + 2 * seq_len * dh
    ffn = 2 * d_model * d_ff
    enc = n_layer * (attn + ffn)
    dec = n_layer * (2 * attn + ffn)
    fwd_macs = enc + dec + d_model * vocab
    return 3 * 2 * fwd_macs


def training_batch(seed, b=TRAIN_BATCH, t=TRAIN_LEN):
    """The reference's make_batch at batch 32, source and target 256 (or
    b and t), with padded tails (pad id 0) of lengths uniform in t/2-t on
    both sides (row 0 unpadded) and label weight 0 on the target pads
    (numpy)."""
    from paddle_tpu_torch import make_batch

    vocab = BASE["src_vocab_size"]
    rng = np.random.RandomState(seed)
    batch = make_batch(b, t, t, BASE["n_head"], vocab, vocab, rng)
    for side in ("src_word", "trg_word"):
        lens = rng.randint(t // 2, t + 1, b)
        lens[0] = t
        pad = np.arange(t)[None, :] >= lens[:, None]
        batch[side][pad] = 0
        if side == "trg_word":
            batch["lbl_weight"][pad] = 0.0
    return batch


def _to(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _step_grads(model, feed, **kw):
    """{name: gradient} of one forward and backward of ``model``, with no
    update: step 1 repeated, which must give the counted step 1's bits."""
    loss, _ = model(**feed, **kw)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return grads


def _require_repeat(grads, repeat, what):
    require(grads.keys() == repeat.keys() and all(
        torch.equal(g, repeat[n]) for n, g in grads.items()),
        f"{what}: step 1's gradients differ from a repeat of the step")


def _grad_rel(got, want):
    return ((got.double() - want.double()).norm()
            / want.double().norm().clamp_min(1e-300)).item()


def run_training(model, cpu_model, cpu64):
    """Phase 3 (d).  The card's model and its f32 CPU copy (same weights)
    take TRAIN_PARITY_STEPS Adam steps on one batch, and a float64 CPU
    copy gives step 1's exact gradient; then the card times
    TRAIN_TIMED_STEPS steps on another batch, repeated.  Returns (the
    run's record, what (e) is held against: the float64 loss and
    gradients, the CPU's f32 gradient error per tensor and its losses);
    every check is fatal."""
    from paddle_tpu_torch import Adam, kernels

    sites = TRAIN_SITES
    batch = training_batch(seed=1)
    opt = Adam(model.parameters(), learning_rate=TRAIN_LR)
    cpu_opt = Adam(cpu_model.parameters(), learning_rate=TRAIN_LR)
    names = {p: n for n, p in model.named_parameters()}
    cpu_names = {p: n for n, p in cpu_model.named_parameters()}
    feed, cpu_feed = _to(batch, "cuda"), _to(batch, "cpu")

    t0 = time.perf_counter()
    loss64, _ = cpu64(**cpu_feed)
    loss64.backward()
    exact = {n: p.grad for n, p in cpu64.named_parameters()
             if p.grad is not None}
    cpu_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, worst_grad, cpu_rel = [], [], {}
    for step in range(TRAIN_PARITY_STEPS):
        loss, _ = model(**feed)
        grads = {names[p]: g for p, g in opt.minimize(loss)}
        torch.cuda.synchronize()
        require(kernels.launches == expected(
            flash_fwd=sites * (step + 1), flash_bwd_dq=sites * (step + 1),
            flash_bwd_dkv=sites * (step + 1)),
            f"training step {step}: launches {kernels.launches}")
        t0 = time.perf_counter()
        cpu_loss, _ = cpu_model(**cpu_feed)
        cpu_grads = {cpu_names[p]: g for p, g in cpu_opt.minimize(cpu_loss)}
        cpu_s += time.perf_counter() - t0
        got, want = loss.item(), cpu_loss.item()
        require(np.isfinite(got) and abs(got - want) <= TOL_TRAIN_LOSS
                * abs(want), f"training step {step}: loss {got} on the "
                f"card, {want} on the CPU")
        losses.append((got, want))
        if step == 0:
            require(np.isfinite(loss64.item()) and abs(got - loss64.item())
                    <= TOL_TRAIN_LOSS * abs(loss64.item()),
                    f"training: loss {got} on the card, {loss64.item()} in "
                    f"float64")
            require(grads.keys() == cpu_grads.keys() == exact.keys(),
                    "training: the card and the CPU trained other params")
            for n, g in grads.items():
                card = _grad_rel(g.cpu(), exact[n])
                cpu_rel[n] = _grad_rel(cpu_grads[n], exact[n])
                require(card <= max(TOL_TRAIN_GRAD, 2 * cpu_rel[n]),
                        f"training step 0: gradient of {n} off float64 by "
                        f"{card} on the card, {cpu_rel[n]} on the CPU in "
                        f"f32")
                worst_grad.append((card, cpu_rel[n], _grad_rel(
                    g.cpu(), cpu_grads[n]), n))
        del grads, cpu_grads
    counts = dict(kernels.launches)
    del cpu_feed

    timed = _timed_training(model, opt, dict(
        flash_fwd=sites, flash_bwd_dq=sites, flash_bwd_dkv=sites))
    for name, c in timed.pop("launches").items():
        counts[name] += c
    worst_grad.sort(reverse=True)
    record = dict(route="training", batch=TRAIN_BATCH, launches=counts,
                  parity_losses=losses, parity_loss_f64=loss64.item(),
                  # (card vs f64, cpu f32 vs f64, card vs cpu f32, name)
                  parity_grad_rel_worst=worst_grad[:4],
                  parity_grad_rel_median=[float(np.median(
                      [w[i] for w in worst_grad])) for i in range(3)],
                  cpu_parity_s=cpu_s, **timed,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    parity = dict(loss64=loss64.item(), exact=exact, cpu_rel=cpu_rel,
                  cpu_losses=[want for _, want in losses])
    return record, parity


def _timed_training(model, opt, per_step):
    """TRAIN_TIMED_STEPS steps of ``model`` on one repeated batch,
    synchronized step by step (host clock); the launches must read
    ``per_step`` times the steps and the loss must fall.  Returns the
    step times, rates and losses, with the launches under "launches"."""
    from paddle_tpu_torch import kernels

    feed = _to(training_batch(seed=2), "cuda")
    step_ms, timed_losses = [], []
    kernels.reset_launches()
    for _ in range(TRAIN_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model(**feed)
        opt.minimize(loss)
        timed_losses.append(loss.item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
    n = TRAIN_TIMED_STEPS
    require(kernels.launches == expected(
        **{name: c * n for name, c in per_step.items()}),
        f"timed training: launches {kernels.launches}")
    require(all(np.isfinite(timed_losses))
            and timed_losses[-1] < timed_losses[0],
            f"training: loss did not fall on a repeated batch "
            f"{timed_losses}")
    med_ms = float(np.median(step_ms))
    tokens = TRAIN_BATCH * TRAIN_LEN  # target tokens, as bench.py counts
    flops_tok = transformer_train_flops_per_token(
        BASE["n_layer"], BASE["d_model"], BASE["d_inner_hid"],
        BASE["n_head"], BASE["d_key"], TRAIN_LEN, BASE["trg_vocab_size"])
    tok_s = tokens / (med_ms / 1e3)
    return dict(step_ms_median=med_ms,
                step_ms_range=(min(step_ms), max(step_ms)),
                tokens_per_s=tok_s, flops_per_token=flops_tok,
                f32_peak_share=tok_s * flops_tok / PEAK_F32_FLOPS,
                timed_losses=timed_losses,
                launches=dict(kernels.launches))


def run_training_fused(model, parity):
    """Phase 3 (e): the default route (``fused_qkv_attention=True``) from
    (d)'s initial weights on (d)'s parity batch: 12 launches each of #1,
    #2 and #3 (the self-attention sites) and 6 each of #4, #6 and #7 (the
    cross sites) per step.  Step 1's gradients must repeat their bits when
    the step is run again; its loss and gradients are held against
    (d)'s float64 evaluation under (d)'s criterion, step 2's loss against
    (d)'s CPU f32 step 2; then timed as (d).  Returns the run's record."""
    from paddle_tpu_torch import Adam, kernels

    L = BASE["n_layer"]
    per_step = dict(qkv_attention_fwd=2 * L, qkv_bwd_dq=2 * L,
                    qkv_bwd_dkv=2 * L, flash_fwd=L, flash_bwd_dq=L,
                    flash_bwd_dkv=L)
    opt = Adam(model.parameters(), learning_rate=TRAIN_LR)
    names = {p: n for n, p in model.named_parameters()}
    feed = _to(training_batch(seed=1), "cuda")
    exact = parity["exact"]
    repeat = _step_grads(model, feed)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, worst_grad = [], []
    for step in range(TRAIN_PARITY_STEPS):
        loss, _ = model(**feed)
        grads = {names[p]: g for p, g in opt.minimize(loss)}
        torch.cuda.synchronize()
        require(kernels.launches == expected(
            **{k: c * (step + 1) for k, c in per_step.items()}),
            f"fused training step {step}: launches {kernels.launches}")
        got = loss.item()
        want = parity["loss64"] if step == 0 else parity["cpu_losses"][step]
        require(np.isfinite(got) and abs(got - want) <= TOL_TRAIN_LOSS
                * abs(want), f"fused training step {step}: loss {got} on "
                f"the card, {want} on the CPU")
        losses.append((got, want))
        if step == 0:
            _require_repeat(grads, repeat, "fused training")
            del repeat
            require(grads.keys() == exact.keys(),
                    "fused training: other params trained than in (d)")
            for n, g in grads.items():
                card = _grad_rel(g.cpu(), exact[n])
                f32 = parity["cpu_rel"][n]
                require(card <= max(TOL_TRAIN_GRAD, 2 * f32),
                        f"fused training step 0: gradient of {n} off "
                        f"float64 by {card} on the card, {f32} on the CPU "
                        f"in f32")
                worst_grad.append((card, f32, n))
        del grads
    counts = dict(kernels.launches)
    timed = _timed_training(model, opt, per_step)
    for name, c in timed.pop("launches").items():
        counts[name] += c
    worst_grad.sort(reverse=True)
    return dict(route="training fused", batch=TRAIN_BATCH, launches=counts,
                # (card, reference): step 1 against float64, step 2
                # against the CPU's f32
                parity_losses=losses,
                # (card vs f64, cpu f32 vs f64, name)
                parity_grad_rel_worst=worst_grad[:4],
                parity_grad_rel_median=[float(np.median(
                    [w[i] for w in worst_grad])) for i in range(2)],
                **timed,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


#: phase 3 (f): the generator seed of step 1's dropout seeds
DROPOUT_STEP_SEED = 5
#: (f): step 1's loss on the flag-off route against the fused route's,
#: relative: the same masks, sums in other orders
TOL_ROUTES_LOSS = 1e-5


def run_training_dropout(model, unfused, cpu32, cpu64):
    """Phase 3 (f): ``model`` (the default route at DROPOUT) takes step 1
    under fixed seeds on (d)'s parity batch, repeating its gradients' bits
    when run again, held against the float64 CPU
    copy ``cpu64`` under (d)'s criterion (the f32 CPU copy ``cpu32``, same
    seeds, gives the CPU's own f32 error); ``unfused`` (the flag-off route,
    the same weights) must give step 1's loss within TOL_ROUTES_LOSS; then
    the timed steps, each drawing fresh seeds.  Returns (step 1's seeds,
    float64 loss and gradients, for (j); the run's record)."""
    from paddle_tpu_torch import Adam, kernels

    L = BASE["n_layer"]
    n_sites = len(model.dropout_sites())
    require(n_sites == 8 * L + 2, f"{n_sites} dropout sites")
    # 2 embedding sites and 5L residual ones: #16 forward, #17 backward
    residual_sites = 2 + 5 * L
    per_step = dict(qkv_attention_fwd=2 * L, qkv_bwd_dq=2 * L,
                    qkv_bwd_dkv=2 * L, flash_fwd=L, flash_bwd_dq=L,
                    flash_bwd_dkv=L, dropout_add_fwd=residual_sites,
                    dropout_add_bwd=residual_sites)
    seeds = torch.randint(0, 2 ** 32, (n_sites,), generator=torch.Generator(
        ).manual_seed(DROPOUT_STEP_SEED)).tolist()
    batch = training_batch(seed=1)
    cpu_feed = _to(batch, "cpu")

    t0 = time.perf_counter()
    exact, cpu_grads, cpu_losses = {}, {}, []
    for copy, grads in ((cpu64, exact), (cpu32, cpu_grads)):
        loss, _ = copy(**cpu_feed, dropout_seeds=seeds)
        loss.backward()
        cpu_losses.append(loss.item())
        grads.update((n, p.grad) for n, p in copy.named_parameters()
                     if p.grad is not None)
    cpu_s = time.perf_counter() - t0
    loss64 = cpu_losses[0]

    opt = Adam(model.parameters(), learning_rate=TRAIN_LR)
    names = {p: n for n, p in model.named_parameters()}
    feed = _to(batch, "cuda")
    repeat = _step_grads(model, feed, dropout_seeds=seeds)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    loss, _ = model(**feed, dropout_seeds=seeds)
    grads = {names[p]: g for p, g in opt.minimize(loss)}
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts == expected(**per_step),
            f"dropout training step 0: launches {counts}")
    got = loss.item()
    require(np.isfinite(got) and abs(got - loss64) <= TOL_TRAIN_LOSS
            * abs(loss64), f"dropout training: loss {got} on the card, "
            f"{loss64} in float64")
    _require_repeat(grads, repeat, "dropout training")
    del repeat
    require(grads.keys() == exact.keys() == cpu_grads.keys(),
            "dropout training: the card and the CPU trained other params")
    worst_grad = []
    for n, g in grads.items():
        card = _grad_rel(g.cpu(), exact[n])
        f32 = _grad_rel(cpu_grads[n], exact[n])
        require(card <= max(TOL_TRAIN_GRAD, 2 * f32),
                f"dropout training step 0: gradient of {n} off float64 by "
                f"{card} on the card, {f32} on the CPU in f32")
        worst_grad.append((card, f32, n))
    del grads, cpu_grads

    with torch.no_grad():
        unfused_loss = unfused(**feed, dropout_seeds=seeds)[0].item()
    require(abs(unfused_loss - got) <= TOL_ROUTES_LOSS * abs(got),
            f"dropout training: flag-off route loss {unfused_loss}, fused "
            f"{got} under the same seeds")

    timed = _timed_training(model, opt, per_step)
    for name, c in timed.pop("launches").items():
        counts[name] += c
    worst_grad.sort(reverse=True)
    # (j) holds the amp step to the same float64 step
    parity = dict(seeds=seeds, loss64=loss64, exact=exact)
    return parity, dict(route="training fused dropout", batch=TRAIN_BATCH,
                dropout_rate=DROPOUT, launches=counts,
                # (card, float64, CPU f32) step-1 losses under one seed set
                parity_losses=(got, loss64, cpu_losses[1]),
                flag_off_loss=unfused_loss,
                # (card vs f64, cpu f32 vs f64, name)
                parity_grad_rel_worst=worst_grad[:4],
                parity_grad_rel_median=[float(np.median(
                    [w[i] for w in worst_grad])) for i in range(2)],
                cpu_parity_s=cpu_s, **timed,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


#: (j) bf16 amp against (f)'s float64 step under the same seeds.  bf16
#: keeps 8 significant bits (a relative step of 2^-8 = 3.9e-3): every
#: matmul output, residual sum and layer-norm output of the step is
#: rounded to it, so no gradient of the bf16 step is closer to float64
#: than a few such steps, and 12 + 12 layers compound them (on the CPU at 2
#: + 2 layers, tests/test_torch_training.py: 4-7% per tensor from the same
#: model's f32 step).  The loss, a mean over 8192 target tokens of
#: 32000-way cross entropies of bf16 logits, within a quarter of a bf16
#: step (1e-3) relative; each gradient tensor within 25% (norm) of
#: float64 (measured on the H100: the loss 4e-6 off, the gradients 4.3%
#: at the median and 8.8% at worst, the first decoder layer's)
TOL_AMP_LOSS, TOL_AMP_GRAD = 1e-3, 0.25


def run_training_amp(model, parity):
    """Phase 3 (j): bf16 amp (``amp.enable``) on the default route at
    DROPOUT from (d)'s initial weights, Transformer-base at
    ``bench_transformer``'s config: step 1 under (f)'s seeds on (d)'s
    parity batch, its gradients repeated to the bit by a second run and
    f32 on every parameter, held against (f)'s float64 step by TOL_AMP_*;
    the exact bf16 launches a step (12 each of #1-#3, 6 each of #4, #6,
    #7, 30 of #16 and #17 at the residual sites) and the f32 #16/#17 at
    the 2 embedding sites, no f32 attention kernel; then the timed steps
    with fresh seeds, their bf16 peak share beside the f32 one.  Returns
    the run's record."""
    from paddle_tpu_torch import Adam, amp, kernels

    L = BASE["n_layer"]
    require(amp.is_enabled(model), "amp training: the model is not enabled")
    per_step = dict(qkv_attention_fwd_bf16=2 * L, qkv_bwd_dq_bf16=2 * L,
                    qkv_bwd_dkv_bf16=2 * L, flash_fwd_bf16=L,
                    flash_bwd_dq_bf16=L, flash_bwd_dkv_bf16=L,
                    dropout_add_fwd_bf16=5 * L, dropout_add_bwd_bf16=5 * L,
                    dropout_add_fwd=2, dropout_add_bwd=2)
    seeds, exact = parity["seeds"], parity["exact"]
    opt = Adam(model.parameters(), learning_rate=TRAIN_LR)
    names = {p: n for n, p in model.named_parameters()}
    feed = _to(training_batch(seed=1), "cuda")
    repeat = _step_grads(model, feed, dropout_seeds=seeds)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    loss, predict = model(**feed, dropout_seeds=seeds)
    require(predict.dtype == torch.bfloat16 and loss.dtype == torch.float32,
            f"amp training: logits {predict.dtype}, loss {loss.dtype}")
    del predict
    grads = {names[p]: g for p, g in opt.minimize(loss)}
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts == expected(**per_step),
            f"amp training step 0: launches {counts}")
    got, loss64 = loss.item(), parity["loss64"]
    require(np.isfinite(got) and abs(got - loss64) <= TOL_AMP_LOSS
            * abs(loss64), f"amp training: loss {got} on the card, {loss64} "
            f"in float64")
    _require_repeat(grads, repeat, "amp training")
    del repeat
    require(grads.keys() == exact.keys(),
            "amp training: other params trained than in (f)")
    worst_grad = []
    for n, g in grads.items():
        require(g.dtype == torch.float32,
                f"amp training: the gradient of {n} reaches Adam in "
                f"{g.dtype}")
        card = _grad_rel(g.cpu(), exact[n])
        require(card <= TOL_AMP_GRAD, f"amp training step 0: gradient of "
                f"{n} off float64 by {card}")
        worst_grad.append((card, n))
    del grads
    timed = _timed_training(model, opt, per_step)
    for name, c in timed.pop("launches").items():
        counts[name] += c
    timed["bf16_peak_share"] = (timed["tokens_per_s"]
                                * timed["flops_per_token"] / PEAK_BF16_FLOPS)
    worst_grad.sort(reverse=True)
    return dict(route="training amp bf16", batch=TRAIN_BATCH,
                dropout_rate=DROPOUT, launches=counts,
                # (card, float64) step-1 losses under (f)'s seeds
                parity_losses=(got, loss64),
                # (card vs f64, name)
                parity_grad_rel_worst=worst_grad[:4],
                parity_grad_rel_median=float(np.median(
                    [w[0] for w in worst_grad])),
                **timed,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


#: (n) amp and (o) f32 training at head width 128: BIG's widths at
#: bench_transformer's config (batch TRAIN_BATCH, lengths TRAIN_LEN,
#: DROPOUT, Adam at TRAIN_LR), on both routes; step 1 is held against a
#: float64 step of the plain path on the CPU at BIG's widths and depth
#: with the batch and lengths cut to HEAD128_TRAIN_PARITY (b, t): a
#: float64 step of 0.25 B parameters at the full batch would take minutes
HEAD128_TRAIN_PARITY = (2, 64)
HEAD128_TRAIN_TIMED_STEPS = 8


def run_head128_train(models, dtype):
    """Phase 3 (n) (``dtype`` bf16: amp, C2 part 2a) or (o) (f32 with
    TF32 off, C2 part 2b): training at head width 128 on BIG's widths
    (Transformer-big's, 8 heads of 128, 6 + 6 layers, vocab 32000) at
    DROPOUT, ``models`` {"fused": the default route, "flag_off":
    ``fused_qkv_attention=False``} on the same seeded weights, under amp
    both ``amp.enable``d.  Step 1 on HEAD128_TRAIN_PARITY's batch under
    fixed seeds on each route: gradients f32, repeated to the bit, held
    against a float64 CPU copy's step of the plain path under the same
    seeds (amp: the loss within TOL_AMP_LOSS, each gradient within
    TOL_AMP_GRAD; f32: the loss within TOL_TRAIN_LOSS, each gradient
    within TOL_TRAIN_GRAD or no further than twice an f32 CPU copy's, as
    (f)), the routes' losses within TOL_AMP_ROUTES_LOSS (amp) or
    TOL_ROUTES_LOSS; then HEAD128_TRAIN_TIMED_STEPS Adam steps on one
    repeated full batch (fresh seeds a step; under amp through an
    ``amp.LossScaler``: the loss scaled, the gradients unscaled and
    checked for overflow): every loss finite, no overflow, the loss
    falling; every step's launches exact (fused: 12 each of #1-#3 and 6
    each of #4, #6, #7 at 128; flag-off: 18 each of #4, #6, #7; 32 each
    of #16/#17, under amp 30 of them in bf16), all under the ``_dh128``
    counters (``_bf16_dh128`` under amp), nothing composed.  Returns
    [record per route]."""
    from paddle_tpu_torch import Adam, Transformer, amp, kernels

    is_amp = dtype == torch.bfloat16
    phase, sfx = ("(n)", "_bf16") if is_amp else ("(o)", "")
    L = BIG["n_layer"]
    # the 5 residual sites a layer in the step's dtype, the 2 embedding
    # sites in f32
    base = {f"dropout_add_{d}{sfx}": 5 * L for d in ("fwd", "bwd")}
    for d in ("fwd", "bwd"):
        base[f"dropout_add_{d}"] = base.get(f"dropout_add_{d}", 0) + 2
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    per_route = {
        "fused": dict(base, **{f"{k}{sfx}_dh128": 2 * L for k in (
            "qkv_attention_fwd", "qkv_bwd_dq", "qkv_bwd_dkv")},
            **{f"{k}{sfx}_dh128": L for k in flash}),
        "flag_off": dict(base, **{f"{k}{sfx}_dh128": 3 * L for k in flash})}
    n_sites = len(models["fused"].dropout_sites())
    seeds = torch.randint(0, 2 ** 32, (n_sites,), generator=torch.Generator(
        ).manual_seed(DROPOUT_STEP_SEED)).tolist()
    pb, pt = HEAD128_TRAIN_PARITY
    batch = training_batch(seed=1, b=pb, t=pt)
    t0 = time.perf_counter()
    # float64, and in f32 an f32 copy: its error bounds the card's
    exact, cpu_grads, cpu_losses = {}, {}, []
    copies = [(torch.float64, exact)]
    if not is_amp:
        copies.append((torch.float32, cpu_grads))
    for copy_dtype, grads in copies:
        copy = Transformer(**BIG, dropout_rate=DROPOUT, device="cpu",
                           fused_qkv_attention=False).to(copy_dtype)
        copy.load_state_dict(models["fused"].state_dict())
        loss, _ = copy(**_to(batch, "cpu"), dropout_seeds=seeds)
        loss.backward()
        cpu_losses.append(loss.item())
        grads.update((n, p.grad) for n, p in copy.named_parameters()
                     if p.grad is not None)
        del copy, loss
    loss64 = cpu_losses[0]
    cpu_s = time.perf_counter() - t0
    tol_loss = TOL_AMP_LOSS if is_amp else TOL_TRAIN_LOSS
    feed = _to(batch, DEV)
    timed_feed = _to(training_batch(seed=2), DEV)
    tokens = TRAIN_BATCH * TRAIN_LEN
    flops_tok = transformer_train_flops_per_token(
        L, BIG["d_model"], BIG["d_inner_hid"], BIG["n_head"], BIG["d_key"],
        TRAIN_LEN, BIG["trg_vocab_size"])
    records = []
    for route, model in models.items():
        require(amp.is_enabled(model) == is_amp,
                f"{phase} {route}: amp enabled {amp.is_enabled(model)}")
        names = {p: n for n, p in model.named_parameters()}
        repeat = _step_grads(model, feed, dropout_seeds=seeds)
        kernels.reset_launches()
        loss, predict = model(**feed, dropout_seeds=seeds)
        require(predict.dtype == dtype,
                f"{phase} {route}: logits {predict.dtype}")
        del predict
        loss.backward()
        grads = {names[p]: p.grad for p in model.parameters()
                 if p.grad is not None}
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        require(counts == expected(**per_route[route]),
                f"{phase} {route} step 1: launches {counts}")
        require(not any(kernels.composed.values()),
                f"{phase} {route}: composed {kernels.composed}")
        got = loss.item()
        require(np.isfinite(got) and abs(got - loss64) <= tol_loss
                * abs(loss64), f"{phase} {route}: loss {got} on the card, "
                f"{loss64} in float64")
        _require_repeat(grads, repeat, f"{phase} {route}")
        del repeat
        require(grads.keys() == exact.keys()
                and (is_amp or cpu_grads.keys() == exact.keys()),
                f"{phase} {route}: other params trained than on the CPU")
        worst = []
        for n, g in grads.items():
            require(g.dtype == torch.float32, f"{phase} {route}: the "
                    f"gradient of {n} is {g.dtype}")
            card = _grad_rel(g.cpu(), exact[n])
            if is_amp:
                require(card <= TOL_AMP_GRAD, f"{phase} {route} step 1: "
                        f"gradient of {n} off float64 by {card}")
                worst.append((card, n))
            else:
                f32 = _grad_rel(cpu_grads[n], exact[n])
                require(card <= max(TOL_TRAIN_GRAD, 2 * f32),
                        f"{phase} {route} step 1: gradient of {n} off "
                        f"float64 by {card} on the card, {f32} on the CPU "
                        "in f32")
                worst.append((card, f32, n))
        del grads
        worst.sort(reverse=True)
        # the timed steps, each one's launches counted on their own
        opt = Adam(model.parameters(), learning_rate=TRAIN_LR)
        scaler = amp.LossScaler() if is_amp else None
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses, gen = [], [], torch.Generator().manual_seed(7)
        for i in range(HEAD128_TRAIN_TIMED_STEPS):
            step_seeds = torch.randint(0, 2 ** 32, (n_sites,),
                                       generator=gen).tolist()
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = model(**timed_feed, dropout_seeds=step_seeds)
            if scaler is None:
                opt.minimize(loss)
            else:
                (loss * scaler.scale).backward()
                finite = torch.ones((), dtype=torch.bool, device=DEV)
                for p in opt.params:
                    if p.grad is not None:
                        p.grad.div_(scaler.scale)
                        finite &= torch.isfinite(p.grad).all()
                overflow = not bool(finite)  # syncs: the backward is done
                scaler.update(overflow)
                if not overflow:
                    opt.step()
                for p in opt.params:
                    p.grad = None
            losses.append(loss.item())  # syncs: the step is done
            step_ms.append((time.perf_counter() - t0) * 1e3)
            require(dict(kernels.launches) == expected(**per_route[route]),
                    f"{phase} {route} timed step {i}: launches "
                    f"{kernels.launches}")
            require(not any(kernels.composed.values()),
                    f"{phase} {route} timed step {i}: composed "
                    f"{kernels.composed}")
        require(all(np.isfinite(losses)) and losses[-1] < losses[0]
                and (scaler is None or scaler.overflow_steps == 0),
                f"{phase} {route}: losses {losses}, "
                f"{scaler and scaler.overflow_steps} overflowed steps")
        n = HEAD128_TRAIN_TIMED_STEPS
        med = float(np.median(step_ms))
        tok_s = tokens / (med / 1e3)
        peak = ("bf16", PEAK_BF16_FLOPS) if is_amp else ("f32",
                                                         PEAK_F32_FLOPS)
        records.append(dict(
            route=f"training {'amp bf16' if is_amp else 'f32'} d_head 128 "
                  f"{route}",
            batch=TRAIN_BATCH, dropout_rate=DROPOUT,
            launches={k: c * (n + 1) for k, c in
                      expected(**per_route[route]).items()},
            parity_batch=[pb, pt],
            # (card, float64[, CPU f32]) step-1 losses under one seed set
            parity_losses=(got, *cpu_losses),
            # (card vs f64[, CPU f32 vs f64], name)
            parity_grad_rel_worst=worst[:4],
            parity_grad_rel_median=[float(np.median([w[i] for w in worst]))
                                    for i in range(len(worst[0]) - 1)],
            cpu_parity_s=cpu_s, step_ms_median=med,
            step_ms_range=(min(step_ms), max(step_ms)),
            tokens_per_s=tok_s, flops_per_token=flops_tok,
            **{f"{peak[0]}_peak_share": tok_s * flops_tok / peak[1]},
            timed_losses=losses,
            **({"loss_scale": scaler.scale} if is_amp else {}),
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9))
        del opt
        torch.cuda.empty_cache()
    records[1]["routes_loss_rel"] = abs(
        records[1]["parity_losses"][0] - records[0]["parity_losses"][0]) / abs(
        records[0]["parity_losses"][0])
    require(records[1]["routes_loss_rel"] <= (
        TOL_AMP_ROUTES_LOSS if is_amp else TOL_ROUTES_LOSS),
            f"{phase}: the routes' step-1 losses "
            f"{records[0]['parity_losses']} and "
            f"{records[1]['parity_losses']}")
    return records


#: (g) the kernel route against the card's plain route (the twins of
#: #18-#21 on the card) at batch 256, from the same weights on the same
#: batch.  The loss and the running statistics come from the forward and
#: agree closely (relative; f32 against float64 on the CPU at 224, batch
#: 4: 1.3e-6).  The gradients do not: at initialization ResNet-50's f32
#: gradient sits 2-4% per tensor off float64 whatever the order of
#: summation (on the CPU at 224, batch 4: medians 2.6% and 2.9%, worst
#: 4.1%, by two convolution algorithms), so two f32 routes differ by as
#: much, and TOL_RESNET_ROUTES_GRAD is twice that spread
TOL_RESNET_ROUTES_LOSS, TOL_RESNET_ROUTES_STATS = 1e-4, 1e-4
TOL_RESNET_ROUTES_GRAD = 0.1


def resnet_batch(b, seed):
    """``bench_resnet50``'s feed: ``rand`` NCHW images in [0, 1) and
    ``randint(0, 1000)`` int64 labels [b, 1] (numpy, seeded)."""
    rng = np.random.RandomState(seed)
    image = rng.rand(b, 3, RESNET_SIZE, RESNET_SIZE).astype(np.float32)
    label = rng.randint(0, RESNET_CLASSES, (b, 1)).astype(np.int64)
    return {"image": image, "label": label}


@contextlib.contextmanager
def plain_conv_bn():
    """The card's plain route: the wrappers of #18-#21 swapped for their
    plain twins (on CUDA tensors, f32 or bf16: the twins compute in their
    inputs' dtype) while the block runs."""
    from paddle_tpu_torch.kernels import conv_bn as kc

    swaps = {"channel_stats_fwd": kc.reference_channel_stats,
             "dot_col_stats_fwd": kc.reference_dot_col_stats,
             "ssa_fwd": kc.reference_ssa_fwd,
             "ssa_bwd": kc.reference_ssa_bwd}
    saved = {name: getattr(kc, name) for name in swaps}
    for name, twin in swaps.items():
        setattr(kc, name, twin)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kc, name, fn)


def _resnet_step(model, feed, opt=None):
    """One forward and backward of ``model`` on ``feed`` and, with
    ``opt``, its Momentum update: (loss, acc, {name: gradient})."""
    names = {p: n for n, p in model.named_parameters()}
    loss, acc, _ = model(**feed)
    if opt is not None:
        grads = {names[p]: g for p, g in opt.minimize(loss)}
    else:
        loss.backward()
        grads = {names[p]: p.grad for p in model.parameters()}
        for p in model.parameters():
            p.grad = None
    return loss.item(), acc.item(), grads


def _resnet_timed(model, opt, feed, per_step=RESNET_LAUNCHES):
    """RESNET_TIMED_STEPS Momentum steps of ``model`` on ``feed`` by the host
    clock, each ended by its loss's ``.item()``: (step ms, losses).  The
    launches of #18-#21 must be ``per_step`` a step (they stay counted
    for the caller)."""
    from paddle_tpu_torch import kernels

    step_ms, losses = [], []
    kernels.reset_launches()
    for _ in range(RESNET_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, _ = model(**feed)
        opt.minimize(loss)
        losses.append(loss.item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
    require(kernels.launches == expected(**{
        n: c * RESNET_TIMED_STEPS for n, c in per_step.items()}),
        f"resnet timed steps: launches {kernels.launches}")
    return step_ms, losses


def _state(model):
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


def run_resnet(model):
    """Phase 3 (g): ResNet-50 training, NHWC, f32, Momentum(0.1, 0.9),
    from ``model``'s weights (kept as the initial state of every leg).
    Step 1 at RESNET_PARITY_BATCH against float64 and f32 CPU copies under
    (d)'s criterion (gradients, running statistics, updated parameters);
    step 1 at RESNET_BATCH, repeated for equal bits and held against the
    card's plain route; then RESNET_TIMED_STEPS timed steps on one
    repeated batch.  Every counted step launches exactly RESNET_LAUNCHES.
    The parity and repeated steps run with cudnn.deterministic; the timed
    ones with PyTorch's defaults.  Returns (the run's record, its parity:
    ``init``, the initial state on the card; ``loss64``, ``exact`` and
    ``exact_state``, the float64 CPU step's loss, gradients and state
    after it; ``f32``, {(kind, name): (card vs float64, CPU f32 vs
    float64)}), which (l) holds its amp step against."""
    from paddle_tpu_torch import Momentum, ResNet, kernels

    init = _state(model)
    cpu_init = {n: t.cpu() for n, t in init.items()}
    feed16 = resnet_batch(RESNET_PARITY_BATCH, seed=1)
    t0 = time.perf_counter()
    cpu = {}
    for dtype in (torch.float64, torch.float32):
        copy = ResNet(RESNET_DEPTH, RESNET_CLASSES, device="cpu").to(dtype)
        copy.load_state_dict(cpu_init)
        feed = {"image": torch.from_numpy(feed16["image"]).to(dtype),
                "label": torch.from_numpy(feed16["label"])}
        loss, _, grads = _resnet_step(copy, feed, Momentum(
            copy.parameters(), RESNET_LR, RESNET_MOMENTUM))
        cpu[dtype] = (loss, grads, _state(copy))
        del copy
    cpu_s = time.perf_counter() - t0
    loss64, exact, exact_state = cpu[torch.float64]
    _, cpu_grads, cpu_state = cpu[torch.float32]

    torch.backends.cudnn.deterministic = True
    counts = expected()
    kernels.reset_launches()
    loss16, _, grads = _resnet_step(model, _to(feed16, "cuda"), Momentum(
        model.parameters(), RESNET_LR, RESNET_MOMENTUM))
    torch.cuda.synchronize()
    require(kernels.launches == expected(**RESNET_LAUNCHES),
            f"resnet step 1 (batch {RESNET_PARITY_BATCH}): launches "
            f"{kernels.launches}")
    counts = {n: c + kernels.launches[n] for n, c in counts.items()}
    require(np.isfinite(loss16) and abs(loss16 - loss64) <= TOL_TRAIN_LOSS
            * abs(loss64), f"resnet: loss {loss16} on the card, {loss64} in "
            f"float64")

    def held(tag, grads, card_state):
        worst = []
        for kind, got, want, f32 in (("grad", grads, exact, cpu_grads),
                                     ("state", card_state, exact_state,
                                      cpu_state)):
            require(got.keys() == want.keys() == f32.keys(),
                    f"{tag}: the card and the CPU hold other {kind} tensors")
            for n in got:
                card = _grad_rel(got[n].cpu(), want[n])
                cpu32 = _grad_rel(f32[n], want[n])
                require(card <= max(TOL_TRAIN_GRAD, 2 * cpu32),
                        f"{tag} step 1: {kind} {n} off float64 by {card} on "
                        f"the card, {cpu32} on the CPU in f32")
                worst.append((card, cpu32, kind, n))
        return worst

    worst = held("resnet", grads, _state(model))
    # C9: the NCHW route (the reference's unfused composition, no kernel)
    # from the same state on the same batch, under the same criterion
    nchw = ResNet(RESNET_DEPTH, RESNET_CLASSES, data_format="NCHW")
    nchw.load_state_dict(init)
    kernels.reset_launches()
    loss_n, _, grads_n = _resnet_step(nchw, _to(feed16, "cuda"), Momentum(
        nchw.parameters(), RESNET_LR, RESNET_MOMENTUM))
    torch.cuda.synchronize()
    require(kernels.launches == expected(), "resnet NCHW launched kernels: "
            f"{kernels.launches}")
    require(np.isfinite(loss_n) and abs(loss_n - loss64) <= TOL_TRAIN_LOSS
            * abs(loss64), f"resnet NCHW: loss {loss_n} on the card, "
            f"{loss64} in float64")
    worst_nchw = sorted(held("resnet NCHW", grads_n, _state(nchw)),
                        reverse=True)
    parity = dict(init=init, loss64=loss64, exact=exact,
                  exact_state=exact_state,
                  f32={(kind, n): (card, cpu32)
                       for card, cpu32, kind, n in worst})
    del grads, cpu_grads, cpu_state, cpu, nchw, grads_n

    feed = _to(resnet_batch(RESNET_BATCH, seed=2), "cuda")
    model.load_state_dict(init)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    loss_k, _, grads_k = _resnet_step(model, feed)
    torch.cuda.synchronize()
    require(kernels.launches == expected(**RESNET_LAUNCHES),
            f"resnet step 1 (batch {RESNET_BATCH}): launches "
            f"{kernels.launches}")
    counts = {n: c + kernels.launches[n] for n, c in counts.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats_k = {n: b.clone() for n, b in model.named_buffers()}
    model.load_state_dict(init)
    loss_r, _, grads_r = _resnet_step(model, feed)
    require(loss_r == loss_k, f"resnet: a repeated step 1 gave loss "
            f"{loss_r}, first {loss_k}")
    _require_repeat(grads_k, grads_r, "resnet (batch 256)")
    del grads_r
    model.load_state_dict(init)
    kernels.reset_launches()
    with plain_conv_bn():
        loss_p, _, grads_p = _resnet_step(model, feed)
    torch.cuda.synchronize()
    require(kernels.launches == expected(), "resnet plain route launched "
            f"kernels: {kernels.launches}")
    require(abs(loss_k - loss_p) <= TOL_RESNET_ROUTES_LOSS * abs(loss_p),
            f"resnet: loss {loss_k} on the kernels, {loss_p} on the plain "
            f"route")
    route_rel = sorted((_grad_rel(grads_k[n], grads_p[n]), n)
                       for n in grads_p)
    require(route_rel[-1][0] <= TOL_RESNET_ROUTES_GRAD,
            f"resnet: gradient of {route_rel[-1][1]} differs between the "
            f"routes by {route_rel[-1][0]}")
    stats_rel = max((_grad_rel(stats_k[n], b), n)
                    for n, b in model.named_buffers())
    require(stats_rel[0] <= TOL_RESNET_ROUTES_STATS,
            f"resnet: running statistic {stats_rel[1]} differs between the "
            f"routes by {stats_rel[0]}")
    del grads_k, grads_p, stats_k

    torch.backends.cudnn.deterministic = False
    model.load_state_dict(init)
    opt = Momentum(model.parameters(), RESNET_LR, RESNET_MOMENTUM)
    step_ms, losses = _resnet_timed(model, opt, feed)
    counts = {n: c + kernels.launches[n] for n, c in counts.items()}
    # the first update must lower the loss on the batch it was taken on;
    # later steps may overshoot: Momentum 0.9 grows the effective step to
    # 10x lr on one repeated batch
    require(all(np.isfinite(losses)) and losses[1] < losses[0],
            f"resnet: the loss did not fall on a repeated batch {losses}")
    med = float(np.median(step_ms))
    ips = RESNET_BATCH / (med / 1e3)
    worst.sort(reverse=True)
    return dict(route="resnet50 training", batch=RESNET_BATCH,
                image=RESNET_SIZE, launches=counts,
                parity_batch=RESNET_PARITY_BATCH,
                parity_losses=(loss16, loss64),
                # (card vs f64, cpu f32 vs f64, kind, name)
                parity_rel_worst=worst[:4],
                parity_grad_rel_median=[float(np.median(
                    [w[i] for w in worst if w[2] == "grad"]))
                    for i in range(2)],
                cpu_parity_s=cpu_s,
                nchw_loss=loss_n, nchw_rel_worst=worst_nchw[:3],
                routes_loss=(loss_k, loss_p),
                routes_grad_rel_worst=route_rel[-3:],
                routes_grad_rel_median=float(np.median(
                    [r for r, _ in route_rel])),
                routes_stats_rel_worst=stats_rel,
                step_ms_median=med, step_ms_range=(min(step_ms),
                                                   max(step_ms)),
                images_per_s=ips,
                f32_peak_share=ips * RESNET_FLOPS_PER_IMAGE / PEAK_F32_FLOPS,
                timed_losses=losses, peak_memory_gb=peak_gb), parity


# -- (l): ResNet-50 under bf16 amp -------------------------------------------

#: one amp step's launches: #18-#21 in bf16 at (g)'s sites, no f32 conv + BN
#: launch
RESNET_AMP_LAUNCHES = {n + "_bf16": c for n, c in RESNET_LAUNCHES.items()}
#: (l) step 1 at RESNET_PARITY_BATCH against (g)'s float64 CPU step.
#: The forward keeps its accuracy in bf16: the loss within
#: TOL_RESNET_AMP_LOSS relative (measured on the H100: 8.9e-4), the
#: running statistics after the step within TOL_RESNET_AMP_STATE at the
#: median (0.0032).  The gradients do not: at initialization this step's
#: gradient moves smoothly with its input until a change near 1e-8 flips
#: a ReLU, and the flips move the gradients of every layer before them
#: by 0.5-0.9% (float64 on the CPU, tools/torch_resnet_conditioning.py).
#: f32's roundings flip a few ((g): 2-4% off float64 per tensor), bf16's
#: many, so the amp gradient keeps each tensor's norm and a share of its
#: direction: 1.33 relative off float64 at the median, which a zero
#: gradient (1.0) would pass (the CPU reads the same of the reference's
#: own amp program).  So each gradient and each parameter's update
#: (after - before) is held by what a zero update and one in another
#: direction fail: its |norm / float64's - 1| within TOL_RESNET_AMP_NORM
#: (measured 0.39 at worst, conv1's bias) and at the median within
#: TOL_RESNET_AMP_NORM_MEDIAN (0.022); the median cosine with float64 at
#: least TOL_RESNET_AMP_COS (0.105; a zero or random direction reads 0);
#: the head (RESNET_AMP_HEAD, which the loss reaches through no batch
#: norm) within TOL_RESNET_AMP_HEAD relative (0.127 at worst, fc_w).  A
#: #20 that drops its residual reads 8.5% on the loss, 244 on a norm, 11.9
#: at the median, a median cosine of 0.002 and 0.66 on fc_w
#: (chip_conv_bn_faults.py residual_bf16)
TOL_RESNET_AMP_LOSS, TOL_RESNET_AMP_STATE = 5e-3, 0.01
TOL_RESNET_AMP_NORM, TOL_RESNET_AMP_NORM_MEDIAN = 0.6, 0.06
TOL_RESNET_AMP_COS, TOL_RESNET_AMP_HEAD = 0.05, 0.3
#: the classifier and the last conv + BN's shift
RESNET_AMP_HEAD = ("fc_w", "fc_b", "stages.3.2.conv3.bias")
#: (l) at RESNET_BATCH, the kernels against the card's plain route (the
#: bf16 twins): the loss, each gradient and its median, each running
#: statistic (relative).  The routes round #19's y (0.003-0.03% of its
#: elements differ) and sum the statistics in other orders, and at this
#: condition a flipped bf16 rounding moves the gradients after it
#: (measured: the loss 6.4e-5, the gradients 16% at the median and 24% at
#: worst, the running statistics 2.1e-3).  #19 in bf16 with its
#: statistics taken from the unrounded accumulators reads 1.02 at the
#: median (chip_conv_bn_faults.py stats_unrounded; phase 2's TOL_SUM
#: catches it too)
TOL_RESNET_AMP_ROUTES_LOSS = 1e-3
TOL_RESNET_AMP_ROUTES_GRAD, TOL_RESNET_AMP_ROUTES_MEDIAN = 0.6, 0.35
TOL_RESNET_AMP_ROUTES_STATS = 1e-2


@contextlib.contextmanager
def _resnet_dtypes(model, seen):
    """Record in ``seen`` the dtype of the stem's conv + BN output and of
    the pooled features while the block runs."""
    from paddle_tpu_torch.models import resnet as rm

    hook = model.conv1.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("stem conv2d_bn", out.dtype))
    pool = rm.pool2d

    def recording(x, *args, **kw):
        out = pool(x, *args, **kw)
        if kw.get("global_pooling"):
            seen["pooled"] = out.dtype
        return out

    rm.pool2d = recording
    try:
        yield
    finally:
        rm.pool2d = pool
        hook.remove()


def run_resnet_amp(model, parity, f32):
    """Phase 3 (l): ResNet-50 training under bf16 amp (``amp.enable``, as
    ``bench_resnet50`` trains) from (g)'s initial weights with fresh
    Momentum state.  Step 1 at RESNET_PARITY_BATCH against (g)'s float64
    CPU step (``parity``): the stem's conv + BN output and the pooled
    features bf16, predict and the loss f32, every gradient reaching
    Momentum f32, the loss within TOL_RESNET_AMP_LOSS, the running
    statistics within TOL_RESNET_AMP_STATE at the median; each gradient's
    and each parameter's update's norm within TOL_RESNET_AMP_NORM of
    float64's (TOL_RESNET_AMP_NORM_MEDIAN at the median), their median
    cosine with float64 at least TOL_RESNET_AMP_COS, and the head
    (RESNET_AMP_HEAD) within TOL_RESNET_AMP_HEAD.  Step 1 at RESNET_BATCH
    under cudnn.deterministic: repeated for equal bits, against the card's
    plain route (``plain_conv_bn``: the bf16 twins) by TOL_RESNET_AMP_ROUTES_*.
    Every counted step launches exactly RESNET_AMP_LAUNCHES and no f32
    conv + BN kernel.  Then RESNET_TIMED_STEPS timed steps, whose loss
    must fall, beside (g)'s f32 record ``f32``.  Returns the run's
    record."""
    from paddle_tpu_torch import Momentum, amp, kernels

    require(amp.is_enabled(model), "resnet amp: the model is not enabled")
    init, loss64 = parity["init"], parity["loss64"]
    exact, exact_state = parity["exact"], parity["exact_state"]
    names = {p: n for n, p in model.named_parameters()}
    torch.backends.cudnn.deterministic = True
    kernels.reset_launches()
    seen = {}
    opt = Momentum(model.parameters(), RESNET_LR, RESNET_MOMENTUM)
    with _resnet_dtypes(model, seen):
        loss, _, predict = model(**_to(resnet_batch(RESNET_PARITY_BATCH,
                                                    seed=1), "cuda"))
    require(seen == {"stem conv2d_bn": torch.bfloat16,
                     "pooled": torch.bfloat16}
            and predict.dtype == torch.float32
            and loss.dtype == torch.float32,
            f"resnet amp: dtypes {seen}, predict {predict.dtype}, loss "
            f"{loss.dtype}")
    del predict
    grads = {names[p]: g for p, g in opt.minimize(loss)}
    torch.cuda.synchronize()
    require(kernels.launches == expected(**RESNET_AMP_LAUNCHES),
            f"resnet amp step 1 (batch {RESNET_PARITY_BATCH}): launches "
            f"{kernels.launches}")
    counts = dict(kernels.launches)
    loss16 = loss.item()
    loss_rel = abs(loss16 - loss64) / abs(loss64)
    require(np.isfinite(loss16) and loss_rel <= TOL_RESNET_AMP_LOSS,
            f"resnet amp: loss {loss16} on the card, {loss64} in float64")
    state = _state(model)
    require(state.keys() == exact_state.keys() and grads.keys()
            == exact.keys(), "resnet amp: other tensors than (g)'s float64 "
            "step")
    require(all(t.dtype == torch.float32 for t in [*grads.values(),
                                                   *state.values()]),
            "resnet amp: a gradient or a state tensor is not f32")
    buffers = [n for n, _ in model.named_buffers()]
    state_median = float(np.median([_grad_rel(state[n].cpu(),
                                              exact_state[n])
                                    for n in buffers]))
    rel, norms, cosines, head = [], [], [], {}
    for n, g in grads.items():
        before = init[n].cpu().double()
        for kind, got, want in (
                ("grad", g.cpu(), exact[n]),
                ("update", state[n].cpu().double() - before,
                 exact_state[n].double() - before)):
            got, want = got.double(), want.double()
            norms.append((abs(got.norm().item() / want.norm().item() - 1),
                          kind, n))
            cosines.append((got.flatten() @ want.flatten()).item()
                           / max(got.norm().item() * want.norm().item(),
                                 1e-300))
            if n in RESNET_AMP_HEAD:
                head[(kind, n)] = _grad_rel(got, want)
            if kind == "grad":
                rel.append((_grad_rel(got, want), kind, n))
    rel.sort(reverse=True)
    norms.sort(reverse=True)
    grad_median = float(np.median([r for r, _, _ in rel]))
    norm_median = float(np.median([r for r, _, _ in norms]))
    cos_median = float(np.median(cosines))
    require(len(head) == 2 * len(RESNET_AMP_HEAD), f"resnet amp: head "
            f"{sorted(head)}")
    require(norms[0][0] <= TOL_RESNET_AMP_NORM
            and norm_median <= TOL_RESNET_AMP_NORM_MEDIAN,
            f"resnet amp step 1: the norm of the {norms[0][1]} of "
            f"{norms[0][2]} off float64's by {norms[0][0]} (median "
            f"{norm_median})")
    require(cos_median >= TOL_RESNET_AMP_COS, f"resnet amp step 1: median "
            f"cosine with float64 {cos_median}")
    worst_head = max(head, key=head.get)
    require(head[worst_head] <= TOL_RESNET_AMP_HEAD, f"resnet amp step 1: "
            f"{worst_head} off float64 by {head[worst_head]}")
    require(state_median <= TOL_RESNET_AMP_STATE, f"resnet amp step 1: "
            f"running statistics off float64 by {state_median} at the "
            "median")
    del grads, loss, opt

    feed = _to(resnet_batch(RESNET_BATCH, seed=2), "cuda")
    model.load_state_dict(init)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    loss_k, _, grads_k = _resnet_step(model, feed)
    torch.cuda.synchronize()
    require(kernels.launches == expected(**RESNET_AMP_LAUNCHES),
            f"resnet amp step 1 (batch {RESNET_BATCH}): launches "
            f"{kernels.launches}")
    counts = {n: c + kernels.launches[n] for n, c in counts.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats_k = {n: b.clone() for n, b in model.named_buffers()}
    model.load_state_dict(init)
    loss_r, _, grads_r = _resnet_step(model, feed)
    require(loss_r == loss_k, f"resnet amp: a repeated step 1 gave loss "
            f"{loss_r}, first {loss_k}")
    _require_repeat(grads_k, grads_r, "resnet amp (batch 256)")
    del grads_r
    model.load_state_dict(init)
    kernels.reset_launches()
    with plain_conv_bn():
        loss_p, _, grads_p = _resnet_step(model, feed)
    torch.cuda.synchronize()
    require(kernels.launches == expected(), "resnet amp plain route "
            f"launched kernels: {kernels.launches}")
    routes_loss = abs(loss_k - loss_p) / abs(loss_p)
    require(routes_loss <= TOL_RESNET_AMP_ROUTES_LOSS,
            f"resnet amp: loss {loss_k} on the kernels, {loss_p} on the "
            f"plain route")
    route_rel = sorted((_grad_rel(grads_k[n], grads_p[n]), n)
                       for n in grads_p)
    route_median = float(np.median([r for r, _ in route_rel]))
    require(route_rel[-1][0] <= TOL_RESNET_AMP_ROUTES_GRAD
            and route_median <= TOL_RESNET_AMP_ROUTES_MEDIAN,
            f"resnet amp: gradient of {route_rel[-1][1]} differs between "
            f"the routes by {route_rel[-1][0]} (median {route_median})")
    stats_rel = max((_grad_rel(stats_k[n], b), n)
                    for n, b in model.named_buffers())
    require(stats_rel[0] <= TOL_RESNET_AMP_ROUTES_STATS,
            f"resnet amp: running statistic {stats_rel[1]} differs between "
            f"the routes by {stats_rel[0]}")
    del grads_k, grads_p, stats_k

    torch.backends.cudnn.deterministic = False
    model.load_state_dict(init)
    opt = Momentum(model.parameters(), RESNET_LR, RESNET_MOMENTUM)
    step_ms, losses = _resnet_timed(model, opt, feed, RESNET_AMP_LAUNCHES)
    counts = {n: c + kernels.launches[n] for n, c in counts.items()}
    require(all(np.isfinite(losses)) and losses[1] < losses[0],
            f"resnet amp: the loss did not fall on a repeated batch {losses}")
    med = float(np.median(step_ms))
    ips = RESNET_BATCH / (med / 1e3)
    return dict(route="resnet50 training amp bf16", batch=RESNET_BATCH,
                image=RESNET_SIZE, launches=counts,
                parity_batch=RESNET_PARITY_BATCH,
                parity_losses=(loss16, loss64), parity_loss_rel=loss_rel,
                # (amp card vs f64, kind, name), and (g)'s f32 (card, CPU)
                # distances of the same tensor
                parity_rel_worst=[(r, kind, n, parity["f32"][(kind, n)])
                                  for r, kind, n in rel[:4]],
                parity_grad_rel_median=grad_median,
                parity_state_rel_median=state_median,
                # |norm / float64's - 1| of the gradients and updates:
                # worst, median; their median cosine with float64; the
                # head's distances
                parity_norm_worst=norms[:3],
                parity_norm_median=norm_median,
                parity_cos_median=cos_median,
                parity_head={f"{k} {n}": r for (k, n), r in head.items()},
                f32_parity_grad_rel_median=float(np.median(
                    [v[0] for (kind, _), v in parity["f32"].items()
                     if kind == "grad"])),
                routes_loss=(loss_k, loss_p),
                routes_grad_rel_worst=route_rel[-3:],
                routes_grad_rel_median=route_median,
                routes_stats_rel_worst=stats_rel,
                step_ms_median=med, step_ms_range=(min(step_ms),
                                                   max(step_ms)),
                images_per_s=ips,
                bf16_peak_share=ips * RESNET_FLOPS_PER_IMAGE
                / PEAK_BF16_FLOPS,
                timed_losses=losses, peak_memory_gb=peak_gb,
                f32=dict(step_ms_median=f32["step_ms_median"],
                         images_per_s=f32["images_per_s"],
                         f32_peak_share=f32["f32_peak_share"],
                         peak_memory_gb=f32["peak_memory_gb"]))


# -- (h): DeepFM -------------------------------------------------------------

#: 8 batches of seeds 0-7 cycled, as ``bench_deepfm`` scans them
DEEPFM_BATCHES, DEEPFM_TIMED_STEPS, DEEPFM_PARITY_STEPS = 8, 10, 3
#: per step: one #22 launch and one #23 launch per table group
DEEPFM_LAUNCHES = dict(multi_table_gather=2, multi_table_apply=2)
#: bench.py's analytic sparse traffic per example (run_deepfm): 26 slots x
#: (10 + 1) f32 x (the gather, the gradient's read and write, both
#: moments' read and write)
DEEPFM_SPARSE_BYTES = DEEPFM_SLOTS * (DEEPFM_EMB + 1) * F32 * 7
#: kernel route against the per-table composition on the card: the
#: reference's own fused-against-per-slot tolerances
#: (tests/test_fused_embedding.py) per element, and TOL_DEEPFM_RTOL of each
#: tensor's largest magnitude: a table's moments (m1 about 1e-6, m2 about
#: 1e-13 at batch 4096) lie far inside the atol
TOL_DEEPFM_RTOL, TOL_DEEPFM_ATOL = 2e-4, 2e-5
#: the float64 check runs at the bench's smoke size
DEEPFM_SMOKE_HASH = 10001


def deepfm_batches(hash_dim, n=DEEPFM_BATCHES):
    """``make_batch(4096, hash_dim, RandomState(s))`` for s < n, as
    (dense, ids [26, b] int32, click) on the card."""
    from paddle_tpu_torch.models.deepfm import batch_tensors, make_batch

    return [batch_tensors(make_batch(DEEPFM_BATCH, hash_dim,
                                     np.random.RandomState(s)), DEV)
            for s in range(n)]


def _deepfm_adam(model):
    from paddle_tpu_torch import Adam

    return Adam(model.parameters(), learning_rate=DEEPFM_LR, lazy_mode=True)


@contextlib.contextmanager
def plain_embedding():
    """The card's plain route of the table updates: the #23 wrappers that
    the optimizers call swapped for their plain twins (on CUDA tensors)
    while the block runs (SGD's goes through the scatter-add one)."""
    from paddle_tpu_torch.kernels import embedding as ke

    swaps = {"multi_table_scatter_add": ke.reference_scatter_add,
             "multi_table_sparse_adam": ke.reference_sparse_adam}
    saved = {name: getattr(ke, name) for name in swaps}
    for name, twin in swaps.items():
        setattr(ke, name, twin)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ke, name, fn)


def _deepfm_state(model, opt):
    """Every parameter and moment of a DeepFM and its Adam, by name."""
    out = {}
    for n, p in model.named_parameters():
        out[n] = p
        st = opt.state[p]
        out[n + "_moment1"], out[n + "_moment2"] = st["moment1"], st["moment2"]
    return out


def _deepfm_steps(model, opt, batches, steps, per_step=None):
    """``steps`` steps cycling ``batches``: the losses; each step's launches
    must equal ``per_step`` when given."""
    from paddle_tpu_torch import kernels

    losses = []
    for i in range(steps):
        kernels.reset_launches()
        loss, _, _ = model(*batches[i % len(batches)])
        opt.minimize(loss)
        losses.append(loss.item())
        if per_step is not None:
            require(kernels.launches == per_step,
                    f"deepfm step {i + 1}: launches {kernels.launches}")
    return losses


def deepfm_float64_check():
    """One step at hash_dim DEEPFM_SMOKE_HASH on the card against float64
    and f32 copies on the CPU from the same weights and batch: the loss
    within TOL_TRAIN_LOSS of float64's, and each parameter's and moment's
    update within TOL_TRAIN_GRAD of float64's or no further than twice the
    CPU's f32 update is ((d)'s criterion).  Returns (the losses, the
    worst three (card, cpu f32, name))."""
    from paddle_tpu_torch import DeepFM
    from paddle_tpu_torch.models.deepfm import batch_tensors, make_batch

    card = DeepFM(hash_dim=DEEPFM_SMOKE_HASH, device=DEV).init_params(5)
    feed = make_batch(DEEPFM_BATCH, DEEPFM_SMOKE_HASH,
                      np.random.RandomState(9))
    start = {k: v.cpu().clone() for k, v in card.state_dict().items()}
    after, losses = {}, {}
    for tag, model, dev in (
            ("card", card, DEV),
            ("f32", DeepFM(hash_dim=DEEPFM_SMOKE_HASH, device="cpu"), "cpu"),
            ("f64", DeepFM(hash_dim=DEEPFM_SMOKE_HASH, device="cpu"),
             "cpu")):
        if tag != "card":
            model.load_state_dict(start)
        if tag == "f64":
            model.double()
        dense, ids, click = batch_tensors(feed, dev)
        before = {n: p.detach().double().cpu().clone()
                  for n, p in model.named_parameters()}
        opt = _deepfm_adam(model)
        loss, _, _ = model(dense.to(next(model.parameters()).dtype), ids,
                           click)
        opt.minimize(loss)
        losses[tag] = loss.item()
        # what the step moved: each parameter's update, each moment (zero
        # before the step)
        after[tag] = {n: t.detach().double().cpu() - before.get(n, 0.0)
                      for n, t in _deepfm_state(model, opt).items()}
    require(abs(losses["card"] - losses["f64"])
            <= TOL_TRAIN_LOSS * abs(losses["f64"]),
            f"deepfm float64 check: loss {losses}")
    worst = []
    for n, want in after["f64"].items():
        card_rel = _grad_rel(after["card"][n], want)
        cpu_rel = _grad_rel(after["f32"][n], want)
        require(card_rel <= max(TOL_TRAIN_GRAD, 2 * cpu_rel),
                f"deepfm float64 check: {n} off float64 by {card_rel} on the "
                f"card, {cpu_rel} on the CPU in f32")
        worst.append((card_rel, cpu_rel, n))
    worst.sort(reverse=True)
    return losses, worst[:3]


def run_deepfm(model):
    """Phase 3 (h): DeepFM training as ``bench_deepfm`` runs it (batch
    4096, hash_dim 1000001, lazy Adam 1e-3, FLAGS_fused_embedding on) from
    ``model``'s weights.  Step 1 twice from the same state: equal bits.
    DEEPFM_PARITY_STEPS steps on the kernel route against the per-table
    composition on the card (``fused_embedding=False`` for the model, the
    #23 wrappers swapped for their twins by :func:`plain_embedding`: no
    kernel launches): losses and every table, weight and moment within
    TOL_DEEPFM_* per element and within TOL_DEEPFM_RTOL of the tensor's
    largest magnitude.  DEEPFM_TIMED_STEPS timed steps
    after one warm-up, cycling the 8 batches: exactly DEEPFM_LAUNCHES a
    step, and the loss must fall below its first value.  One step at the
    smoke size against float64 (:func:`deepfm_float64_check`).  Returns
    the run's record."""
    from paddle_tpu_torch import DeepFM, kernels

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batches = deepfm_batches(DEEPFM_HASH)
    init = _state(model)
    per_step = expected(**DEEPFM_LAUNCHES)
    counts = expected()

    snaps = []
    for _ in range(2):
        model.load_state_dict(init)
        opt = _deepfm_adam(model)
        losses_k = _deepfm_steps(model, opt, batches, 1, per_step)
        snaps.append({n: t.clone()
                      for n, t in _deepfm_state(model, opt).items()})
        counts = {n: c + kernels.launches[n] for n, c in counts.items()}
    require(snaps[0].keys() == snaps[1].keys() and all(
        torch.equal(t, snaps[1][n]) for n, t in snaps[0].items()),
        "deepfm: a repeated step 1 gave other bits")
    del snaps
    losses_k += _deepfm_steps(model, opt, batches[1:],
                              DEEPFM_PARITY_STEPS - 1, per_step)
    counts = {n: c + (DEEPFM_PARITY_STEPS - 1) * per_step[n]
              for n, c in counts.items()}
    composed = DeepFM(hash_dim=DEEPFM_HASH, fused_embedding=False,
                      device=DEV)
    composed.load_state_dict(init)
    opt_c = _deepfm_adam(composed)
    with plain_embedding():
        losses_c = _deepfm_steps(composed, opt_c, batches,
                                 DEEPFM_PARITY_STEPS, expected())
    require(np.allclose(losses_k, losses_c, rtol=TOL_DEEPFM_RTOL,
                        atol=TOL_DEEPFM_ATOL),
            f"deepfm: losses {losses_k} on the kernels, {losses_c} on the "
            f"per-table composition")
    mine = _deepfm_state(model, opt)
    worst, worst_scaled = (-1.0, ""), (0.0, "")
    with torch.no_grad():
        for n, want in _deepfm_state(composed, opt_c).items():
            diff = (mine[n] - want).abs()
            err = diff - TOL_DEEPFM_RTOL * want.abs()
            worst = max(worst, (err.max().item(), n))
            scaled = diff.max().item() / max(want.abs().max().item(), 1e-30)
            worst_scaled = max(worst_scaled, (scaled, n))
    require(worst[0] <= TOL_DEEPFM_ATOL, f"deepfm: {worst[1]} differs "
            f"between the kernel route and the composition by {worst[0]} "
            f"over rtol {TOL_DEEPFM_RTOL}")
    require(worst_scaled[0] <= TOL_DEEPFM_RTOL, f"deepfm: {worst_scaled[1]} "
            f"differs between the kernel route and the composition by "
            f"{worst_scaled[0]} of its largest magnitude")
    del composed, opt_c, mine
    parity_s = time.perf_counter() - t0

    model.load_state_dict(init)
    opt = _deepfm_adam(model)
    losses = _deepfm_steps(model, opt, batches, 1, per_step)   # warm-up
    step_ms = []
    kernels.reset_launches()
    for i in range(1, DEEPFM_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, auc, _ = model(*batches[i % DEEPFM_BATCHES])
        opt.minimize(loss)
        losses.append(loss.item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t1) * 1e3)
    require(kernels.launches == expected(**{
        n: c * DEEPFM_TIMED_STEPS for n, c in DEEPFM_LAUNCHES.items()}),
        f"deepfm timed steps: launches {kernels.launches}")
    counts = {n: c + kernels.launches[n] + per_step[n]
              for n, c in counts.items()}
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"deepfm: the loss did not fall over the run {losses}")
    med = float(np.median(step_ms))
    eps = DEEPFM_BATCH / (med / 1e3)
    f64_losses, f64_worst = deepfm_float64_check()
    return dict(route="deepfm training", batch=DEEPFM_BATCH,
                hash_dim=DEEPFM_HASH, launches=counts,
                step_ms_median=med, step_ms_range=(min(step_ms),
                                                   max(step_ms)),
                examples_per_s=eps,
                sparse_bytes_share=eps * DEEPFM_SPARSE_BYTES
                / PEAK_BYTES_PER_S,
                timed_losses=losses, auc=auc.item(),
                routes_losses=(losses_k, losses_c),
                routes_worst_over_rtol=worst,
                routes_worst_of_largest=worst_scaled, parity_s=parity_s,
                float64_losses=f64_losses, float64_rel_worst=f64_worst,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def run_demo_head16():
    """Phase 3, C2: the reference demo's widths (head width 16) served on
    the card through the batcher, driven synchronously: no attention or
    decode kernel launches, the composition counter counts the routed
    calls, and every request gets the CPU plain path's tokens."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import (ContinuousBatcher,
                                          build_demo_generation_model)
    from paddle_tpu_torch.serving.generation import _GenRequest

    prompts = [[5, 9, 3], [5, 9, 3], [7, 2], [11, 4, 8, 1, 6], [3] * 8]
    tokens = {}
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        served = build_demo_generation_model(device=dev)
        if side == "cpu":
            served.session.model.load_state_dict(
                {k: v.cpu() for k, v in card_state.items()})
        else:
            card_state = served.session.model.state_dict()
        served.warmup()
        batcher = ContinuousBatcher(served)
        reqs = [_GenRequest(list(p), 12) for p in prompts]
        kernels.reset_launches()
        for r in reqs:
            batcher._pending_join.append(r)
        for _ in range(300):
            if all(r.event.is_set() for r in reqs):
                break
            batcher._admit()
            batcher._step()
        require(all(r.event.is_set() and r.error is None for r in reqs),
                f"demo ({side}): requests did not finish")
        tokens[side] = [list(r.tokens) for r in reqs]
        if side == "card":
            torch.cuda.synchronize()
            launches, composed = dict(kernels.launches), dict(
                kernels.composed)
    require(launches == expected(), f"demo at head width 16 launched "
            f"kernels: {launches}")
    require(composed["qkv_attention_fwd"] > 0 and composed["megastep"] > 0
            and composed["ffn"] > 0,
            f"demo at head width 16: composition counts {composed}")
    require(tokens["card"] == tokens["cpu"],
            f"demo at head width 16: tokens {tokens['card']} on the card, "
            f"{tokens['cpu']} on the CPU")
    return dict(route="demo head width 16", launches=launches,
                composed={k: v for k, v in composed.items() if v},
                requests=len(prompts),
                tokens=sum(len(t) for t in tokens["card"]))


def bert_train_flops_per_token(n_layer, d_model, d_ff, seq_len, vocab):
    """Analytic matmul FLOPs per token, encoder-only + MLM head (2 FLOPs
    per MAC, train = 3x fwd).  Copied from the reference's ``bench.py``."""
    attn = 4 * d_model * d_model + 2 * seq_len * d_model
    fwd_macs = n_layer * (attn + 2 * d_model * d_ff) + d_model * vocab
    return 3 * 2 * fwd_macs


def bert_batch(b, seed):
    """The reference's make_batch at batch b and BERT's widths, with padded
    tails (input mask and label weights 0) of lengths uniform in 64-128
    (row 0 unpadded), so the attention bias matters (numpy)."""
    from paddle_tpu_torch import make_bert_batch

    t = BERT["seq_len"]
    rng = np.random.RandomState(seed)
    batch = make_bert_batch(b, t, BERT["vocab_size"], rng)
    lens = rng.randint(t // 2, t + 1, b)
    lens[0] = t
    pad = np.arange(t)[None, :] >= lens[:, None]
    batch["input_mask"][pad] = 0.0
    batch["mask_weights"][pad] = 0.0
    return batch


def _bert_models():
    """BERT-base at DROPOUT from ``init_params(0)`` on the card: the
    default build after ``attention_fuse`` (the bhtd kernels), the same
    weights on the ``use_flash=True`` route (#1-#3), and on the unfused
    composition (no pass)."""
    from paddle_tpu_torch import BertPretrain, attention_fuse

    fused = BertPretrain(**BERT, dropout_rate=DROPOUT,
                         device=DEV).init_params(0)
    require(attention_fuse(fused) == BERT["n_layer"],
            "attention_fuse did not switch every BERT layer")
    flash = BertPretrain(**BERT, dropout_rate=DROPOUT, use_flash=True,
                         device=DEV)
    composed = BertPretrain(**BERT, dropout_rate=DROPOUT, device=DEV)
    for m in (flash, composed):
        m.load_state_dict(fused.state_dict())
    return fused, flash, composed


def _bert_timed(model, opt, per_step, seed):
    """BERT_TIMED_STEPS steps of ``model`` on one repeated batch, each with
    fresh dropout seeds, synchronized step by step (host clock); the
    launches must read ``per_step`` times the steps and the loss must
    fall.  Returns the step times, rates, losses and peak memory."""
    from paddle_tpu_torch import kernels

    feed = _to(bert_batch(BERT_BATCH, seed=2), DEV)
    gen = torch.Generator().manual_seed(seed)
    step_ms, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for _ in range(BERT_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model(**feed, generator=gen)
        opt.minimize(loss)
        losses.append(loss.item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
    n = BERT_TIMED_STEPS
    require(kernels.launches == expected(
        **{name: c * n for name, c in per_step.items()}),
        f"timed BERT steps: launches {kernels.launches}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"BERT: loss did not fall on a repeated batch {losses}")
    med_ms = float(np.median(step_ms))
    tok_s = BERT_BATCH * BERT["seq_len"] / (med_ms / 1e3)
    flops_tok = bert_train_flops_per_token(
        BERT["n_layer"], BERT["d_model"], BERT["d_ff"], BERT["seq_len"],
        BERT["vocab_size"])
    return dict(step_ms_median=med_ms, step_ms_range=(min(step_ms),
                                                      max(step_ms)),
                tokens_per_s=tok_s, flops_per_token=flops_tok,
                f32_peak_share=tok_s * flops_tok / PEAK_F32_FLOPS,
                timed_losses=losses, launches=dict(kernels.launches),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def run_bert(fused, flash, composed):
    """Phase 3 (i): BERT-base pretraining at DROPOUT.  ``fused`` (the
    default build after ``attention_fuse``) takes step 1 under fixed
    per-site seeds at BERT_BATCH, twice for equal gradient bits, with 12
    launches each of #5, #8 and #9 and 25 each of #16 and #17 (24
    residual sites and the embedding's) and no other; at
    BERT_PARITY_BATCH the same step is held against float64 and f32 CPU
    copies under the same seeds by (d)'s criterion.  ``flash``
    (``use_flash=True``: 12 each of #1-#3) must give step 1's loss within
    TOL_ROUTES_LOSS under the same seeds (the same masks), and
    ``composed`` (no pass) the fused route's rate-0 loss.  Then both
    kernel routes are timed.  Returns the (fused, flash) records and the
    float64 step for (k): {"seeds": {site: seed}, "exact": {name:
    float64 gradient}, "loss64": its loss} at BERT_PARITY_BATCH."""
    from paddle_tpu_torch import Adam, BertPretrain, attention_fuse, kernels

    L = BERT["n_layer"]
    drops = dict(dropout_add_fwd=2 * L + 1, dropout_add_bwd=2 * L + 1)
    per_fused = dict(flash_fwd_bhtd=L, flash_bwd_dq_bhtd=L,
                     flash_bwd_dkv_bhtd=L, **drops)
    per_flash = dict(qkv_attention_fwd=L, qkv_bwd_dq=L, qkv_bwd_dkv=L,
                     **drops)
    sites = fused.dropout_sites()
    require(len(sites) == 3 * L + 1, f"{len(sites)} BERT dropout sites")
    # one seed per site name, whichever order a route lists its sites in
    by_site = dict(zip(sites, torch.randint(
        0, 2 ** 32, (len(sites),), generator=torch.Generator().manual_seed(
            DROPOUT_STEP_SEED)).tolist()))

    def seeds(model):
        return [by_site[name] for name in model.dropout_sites()]

    # step 1 at the parity batch against float64 and f32 CPU copies
    small = bert_batch(BERT_PARITY_BATCH, seed=3)
    t0 = time.perf_counter()
    exact, cpu_grads, cpu_losses = {}, {}, []
    for dtype, grads in ((torch.float64, exact), (torch.float32, cpu_grads)):
        copy = BertPretrain(**BERT, dropout_rate=DROPOUT,
                            device="cpu").to(dtype)
        attention_fuse(copy)
        copy.load_state_dict({k: v.cpu() for k, v in
                              fused.state_dict().items()})
        loss, _ = copy(**_to(small, "cpu"), dropout_seeds=seeds(copy))
        loss.backward()
        cpu_losses.append(loss.item())
        grads.update((n, p.grad) for n, p in copy.named_parameters())
        del copy
    cpu_s = time.perf_counter() - t0
    small_loss, _ = fused(**_to(small, DEV), dropout_seeds=seeds(fused))
    small_loss.backward()
    card_small = {n: p.grad for n, p in fused.named_parameters()}
    fused.zero_grad(set_to_none=True)
    small_loss = small_loss.item()
    require(abs(small_loss - cpu_losses[0]) <= TOL_TRAIN_LOSS
            * abs(cpu_losses[0]), f"BERT batch {BERT_PARITY_BATCH}: loss "
            f"{small_loss} on the card, {cpu_losses[0]} in float64")
    worst_grad = []
    for n, g in card_small.items():
        card = _grad_rel(g.cpu(), exact[n])
        f32 = _grad_rel(cpu_grads[n], exact[n])
        require(card <= max(TOL_TRAIN_GRAD, 2 * f32),
                f"BERT step 1: gradient of {n} off float64 by {card} on "
                f"the card, {f32} on the CPU in f32")
        worst_grad.append((card, f32, n))
    worst_grad.sort(reverse=True)
    del card_small, cpu_grads

    # step 1 at BERT_BATCH: repeated for equal bits, then counted
    feed = _to(bert_batch(BERT_BATCH, seed=1), DEV)
    repeat = _step_grads(fused, feed, dropout_seeds=seeds(fused))
    opt = Adam(fused.parameters(), learning_rate=BERT_LR)
    names = {p: n for n, p in fused.named_parameters()}
    kernels.reset_launches()
    loss, _ = fused(**feed, dropout_seeds=seeds(fused))
    grads = {names[p]: g for p, g in opt.minimize(loss)}
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts == expected(**per_fused),
            f"BERT fused step 1: launches {counts}")
    _require_repeat(grads, repeat, "BERT fused route")
    fused_loss = loss.item()
    del grads, repeat

    flash_opt = Adam(flash.parameters(), learning_rate=BERT_LR)
    kernels.reset_launches()
    loss, _ = flash(**feed, dropout_seeds=seeds(flash))
    flash_opt.minimize(loss)
    torch.cuda.synchronize()
    flash_counts = dict(kernels.launches)
    require(flash_counts == expected(**per_flash),
            f"BERT use_flash step 1: launches {flash_counts}")
    flash_loss = loss.item()
    require(abs(flash_loss - fused_loss) <= TOL_ROUTES_LOSS * abs(fused_loss),
            f"BERT step 1: use_flash loss {flash_loss}, fused {fused_loss} "
            f"under the same seeds")

    # rate 0 (eval mode): the unfused composition against the fused route
    # at its initial weights, no kernel on the composition
    fused_0 = BertPretrain(**BERT, device=DEV)
    attention_fuse(fused_0)
    fused_0.load_state_dict(composed.state_dict())
    with torch.no_grad():
        kernels.reset_launches()
        composed_loss = composed.eval()(**feed)[0].item()
        require(kernels.launches == expected(),
                f"BERT composition launched {kernels.launches}")
        rate0_loss = fused_0.eval()(**feed)[0].item()
    del fused_0
    require(abs(composed_loss - rate0_loss) <= TOL_ROUTES_LOSS
            * abs(rate0_loss), f"BERT rate 0: composed loss "
            f"{composed_loss}, fused {rate0_loss}")

    records = []
    for route, model, o, c, per in (
            ("bert fused (attention_fuse, bhtd)", fused, opt, counts,
             per_fused),
            ("bert use_flash (fused qkv)", flash, flash_opt, flash_counts,
             per_flash)):
        timed = _bert_timed(model, o, per, seed=len(records) + 7)
        for name, n in timed.pop("launches").items():
            c[name] += n
        records.append(dict(route=route, batch=BERT_BATCH,
                            dropout_rate=DROPOUT, launches=c, **timed))
    records[0].update(
        # (card, float64, CPU f32) step-1 losses at the parity batch
        parity_losses=(small_loss, *cpu_losses),
        # (card vs f64, cpu f32 vs f64, name)
        parity_grad_rel_worst=worst_grad[:4],
        parity_grad_rel_median=[float(np.median([w[i] for w in worst_grad]))
                                for i in range(2)],
        cpu_parity_s=cpu_s, step1_loss=fused_loss,
        use_flash_step1_loss=flash_loss, rate0_loss=rate0_loss,
        composed_rate0_loss=composed_loss)
    return records, dict(seeds=by_site, exact=exact, loss64=cpu_losses[0])


#: (k): the two kernel routes' step-1 losses under the same seeds at
#: BERT_BATCH, relative.  The routes round at other points in bf16 (the
#: ``use_flash`` route projects q, k, v inside #1 and splits them hi/lo;
#: the bhtd route rounds them to bf16 in its qkv ``mul`` before #5), so
#: their losses differ by bf16 roundings averaged over the batch's
#: masked-LM tokens: within a quarter of a bf16 step (1e-3), as
#: TOL_AMP_LOSS
TOL_AMP_ROUTES_LOSS = 1e-3


def run_bert_amp(fused, flash, parity):
    """Phase 3 (k): BERT-base pretraining under bf16 amp (``amp.enable``:
    the reference's cast policy, as ``bench_bert`` runs it) on both kernel
    routes, the models of (i) reloaded with their initial weights by the
    caller and fresh Adam state.  Each route's step 1 under (i)'s per-site
    seeds: at BERT_PARITY_BATCH the encoder output bf16, the loss f32 and
    held against (i)'s float64 step by TOL_AMP_LOSS, every gradient f32 and
    within TOL_AMP_GRAD of float64; at BERT_BATCH repeated to the bit by a
    second run, with the exact launches (the bhtd route 12 each of #5, #8,
    #9 in bf16, ``use_flash`` 12 each of #1-#3 in bf16; both 24 each of
    #16 and #17 in bf16 at the residual sites and 1 each in f32 at the
    embedding's; no f32 attention kernel); the two routes' losses within
    TOL_AMP_ROUTES_LOSS.  Then BERT_TIMED_STEPS timed steps with fresh
    seeds, whose loss must fall, their bf16 peak share beside.  Returns
    the (bhtd, use_flash) records."""
    from paddle_tpu_torch import Adam, amp, kernels

    L = BERT["n_layer"]
    drops = dict(dropout_add_fwd_bf16=2 * L, dropout_add_bwd_bf16=2 * L,
                 dropout_add_fwd=1, dropout_add_bwd=1)
    routes = (("bert amp bf16 bhtd (attention_fuse)", fused,
               dict(flash_fwd_bhtd_bf16=L, flash_bwd_dq_bhtd_bf16=L,
                    flash_bwd_dkv_bhtd_bf16=L, **drops)),
              ("bert amp bf16 use_flash (fused qkv)", flash,
               dict(qkv_attention_fwd_bf16=L, qkv_bwd_dq_bf16=L,
                    qkv_bwd_dkv_bf16=L, **drops)))
    by_site, exact, loss64 = (parity[k] for k in ("seeds", "exact",
                                                   "loss64"))
    small = _to(bert_batch(BERT_PARITY_BATCH, seed=3), DEV)
    feed = _to(bert_batch(BERT_BATCH, seed=1), DEV)
    records = []
    for route, model, per_step in routes:
        require(amp.is_enabled(model), f"{route}: the model is not enabled")
        seeds = [by_site[name] for name in model.dropout_sites()]
        names = {p: n for n, p in model.named_parameters()}
        # step 1 at the parity batch against (i)'s float64 step
        loss, enc = model(**small, dropout_seeds=seeds)
        require(enc.dtype == torch.bfloat16 and loss.dtype == torch.float32,
                f"{route}: encoder output {enc.dtype}, loss {loss.dtype}")
        loss.backward()
        small_loss = loss.item()
        require(np.isfinite(small_loss) and abs(small_loss - loss64)
                <= TOL_AMP_LOSS * abs(loss64), f"{route} batch "
                f"{BERT_PARITY_BATCH}: loss {small_loss} on the card, "
                f"{loss64} in float64")
        require(exact.keys() == {n for n, _ in model.named_parameters()},
                f"{route}: other parameters than (i)'s float64 step")
        worst_grad = []
        for n, p in model.named_parameters():
            require(p.grad.dtype == torch.float32,
                    f"{route}: the gradient of {n} is {p.grad.dtype}")
            card = _grad_rel(p.grad.cpu(), exact[n])
            require(card <= TOL_AMP_GRAD, f"{route} step 1: gradient of "
                    f"{n} off float64 by {card}")
            worst_grad.append((card, n))
        model.zero_grad(set_to_none=True)
        worst_grad.sort(reverse=True)

        # step 1 at BERT_BATCH: repeated for equal bits, then counted
        repeat = _step_grads(model, feed, dropout_seeds=seeds)
        opt = Adam(model.parameters(), learning_rate=BERT_LR)
        kernels.reset_launches()
        loss, _ = model(**feed, dropout_seeds=seeds)
        grads = {names[p]: g for p, g in opt.minimize(loss)}
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        require(counts == expected(**per_step),
                f"{route} step 1: launches {counts}")
        _require_repeat(grads, repeat, route)
        require(all(g.dtype == torch.float32 for g in grads.values()),
                f"{route}: a gradient reaches Adam in another dtype than "
                "f32")
        step1 = loss.item()
        del grads, repeat, loss, enc
        timed = _bert_timed(model, opt, per_step, seed=len(records) + 17)
        for name, c in timed.pop("launches").items():
            counts[name] += c
        timed["bf16_peak_share"] = (timed["tokens_per_s"]
                                    * timed["flops_per_token"]
                                    / PEAK_BF16_FLOPS)
        records.append(dict(
            route=route, batch=BERT_BATCH, dropout_rate=DROPOUT,
            launches=counts,
            # (card, float64) step-1 losses at the parity batch
            parity_losses=(small_loss, loss64),
            # (card vs f64, name)
            parity_grad_rel_worst=worst_grad[:4],
            parity_grad_rel_median=float(np.median(
                [w[0] for w in worst_grad])),
            step1_loss=step1, **timed))
        del opt
    l0, l1 = records[0]["step1_loss"], records[1]["step1_loss"]
    require(abs(l1 - l0) <= TOL_AMP_ROUTES_LOSS * abs(l0),
            f"BERT amp step 1: use_flash loss {l1}, bhtd {l0} under the "
            f"same seeds")
    return records


# ---------------------------------------------------------------------------
# phase 4: where the time goes (torch.profiler)
# ---------------------------------------------------------------------------


def _device_kernels(prof):
    """[(name, device us)] of the device-side events, largest first (not
    the device-side spans of ``profile_training``'s "step: " ranges)."""
    from torch.autograd import DeviceType

    rows = [(e.key, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("step: ")]
    return sorted(rows, key=lambda r: -r[1])


def profile_serving(model, b, steps=16, paged=False, tag=""):
    """Device time by kernel over one prefill and `steps` decode steps,
    beside host wall time: the device's idle share of each phase (on
    paged caches with ``paged``), on the model's route (fused or
    unfused decode step); the megastep's, the FFN's and flash-decode's
    (#14/#15: a kernel named ``*decode*kernel*``) device time a step.
    ``tag`` names the profile files."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import GenerationSession

    kw = dict(bos_id=0, eos_id=-1, paged=paged)
    sess = GenerationSession(model, b, SRC_LEN, MAX_OUT, **kw)
    src = source_batch(b, seed=b)
    sess.prefill(src)  # warm
    for _ in range(4):
        sess.decode_step()
    sess = GenerationSession(model, b, SRC_LEN, MAX_OUT, **kw)
    out = {}
    for phase in ("prefill", "decode"):
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                sess.prefill(src)
            else:
                for _ in range(steps):
                    sess.decode_step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        per = 1 if phase == "prefill" else steps
        rows = _device_kernels(prof)
        busy_us = sum(us for _, us in rows)
        out[phase] = dict(wall_ms=wall_us / per / 1e3,
                          device_busy_ms=busy_us / per / 1e3,
                          megastep_ms=sum(
                              us for name, us in rows
                              if "megastep_kernel" in name) / per / 1e3,
                          ffn_ms=sum(
                              us for name, us in rows
                              if "ffn_kernel" in name) / per / 1e3,
                          flash_decode_ms=sum(
                              us for name, us in rows
                              if "decode" in name and "kernel" in name)
                          / per / 1e3,
                          idle_share=(1 - busy_us / wall_us
                                      if busy_us else None),
                          top=[(name[:60], us / per / 1e3)
                               for name, us in rows[:8]])
        name = f"profile_b{b}{'_paged' if paged else ''}{tag}_{phase}.txt"
        with open(os.path.join(OUT_DIR, name),
                  "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    return out


def profile_training(model, tag, feed=None, lr=TRAIN_LR):
    """Device time by kernel over one training step (forward, backward,
    Adam) on ``feed`` (the Transformer's timed batch by default), beside
    host wall time, and split by phase (``phases``: the forward, the
    optimizer's step, and the backward as "other"), by the op that
    launched it (``by_op``) and among PyTorch's elementwise and reduction
    kernels by name (``elementwise``), #16/#17's (``dropout_add_ms``)
    beside; the table goes to ``profile_training_step_<tag>.txt``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch import Adam

    opt = Adam(model.parameters(), learning_rate=lr)
    if feed is None:
        feed = _to(training_batch(seed=2), "cuda")
    opt.minimize(model(**feed)[0])  # warm: the allocator and the state
    torch.cuda.synchronize()
    step = opt.step

    def traced_step():
        with record_function("step: optimizer"):
            step()

    opt.step = traced_step  # minimize's update, inside its own range
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("step: forward"):
            loss = model(**feed)[0]
        opt.minimize(loss)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_kernels(prof)
    busy_us = sum(us for _, us in rows)
    phases = _phase_device_ms(prof, ("step: forward", "step: optimizer"))
    with open(os.path.join(OUT_DIR, f"profile_training_step_{tag}.txt"),
              "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                idle_share=1 - busy_us / wall_us if busy_us else None,
                gemm_cuh_ms=_gemm_cuh_us(rows) / 1e3,
                walks_ms=_walks_us(rows) / 1e3,
                qkv_fwd_ms=_attention_fwd_us(rows)[0] / 1e3,
                flash_fwd_ms=_attention_fwd_us(rows)[1] / 1e3,
                # the bf16 kernels on tensor cores: #4's, #1's attention,
                # the tile (#1's y, the pair's GEMM stages), the pair's
                # walks
                tensor_core_ms=sum(us for name, us in rows if any(
                    k in name for k, _ in TC_KERNELS)) / 1e3,
                # cuBLAS's kernels (Hopper's bf16 ones are "nvjet_*")
                library_gemm_ms=sum(
                    us for name, us in rows
                    if ("gemm" in name.lower() or "cutlass" in name
                        or name.startswith("nvjet"))
                    and "(anonymous namespace)" not in name) / 1e3,
                phases=phases,
                # #5, #8 and #9 in bf16: the tensor-core kernels on Bhtd
                bhtd_bf16_ms={k: sum(us for name, us in rows
                                     if f"::{k}<" in name and "Bhtd" in name)
                              / 1e3 for k in ("flash_fwd_tc_kernel",
                                              "flash_dq_tc_kernel",
                                              "flash_dkv_tc_kernel")},
                dropout_add_ms=_dropout_add_us(rows) / 1e3,
                elementwise_ms=sum(us for _, us in _elementwise(rows)) / 1e3,
                elementwise=[(name[:160], us / 1e3)
                             for name, us in _elementwise(rows)[:16]],
                by_op=_op_device_ms(prof),
                top=[(name[:60], us / 1e3) for name, us in rows[:12]])


def _phase_device_ms(prof, ranges):
    """{range: device ms} of the kernels that ran inside each of the
    host-side ``ranges``' device-side spans (one stream runs its kernels
    in launch order, so a span holds its range's kernels and no others),
    and of the rest under "other" (the backward, between them); None
    where the profiler recorded no device-side span."""
    from torch.autograd import DeviceType

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {e.name: e.time_range for e in device if e.name in ranges}
    if len(spans) < len(ranges):
        return None
    out = dict.fromkeys([*ranges, "other"], 0.0)
    for e in device:
        if e.name.startswith("step: "):
            continue
        inside = [n for n, r in spans.items()
                  if r.start <= e.time_range.start <= r.end]
        out[inside[0] if inside else "other"] += (
            e.time_range.end - e.time_range.start) / 1e3
    return out


def _dropout_add_us(rows):
    """Device us of #16's and #17's kernels (``csrc/dropout_add.cu``, f32
    and bf16, every path) among the profiler's rows."""
    return sum(us for name, us in rows if "::dropout_kernel<" in name
               or "::dropout_elements_kernel<" in name)


def _elementwise(rows):
    """The profiler's rows of PyTorch's elementwise and reduction kernels
    (their names carry the functor: the op and its dtype), largest
    first."""
    return [(name, us) for name, us in rows
            if name.startswith(("void at::native::", "at::native::"))
            and ("elementwise" in name or "reduce_kernel" in name
                 or "multi_tensor_apply" in name)]


def _op_device_ms(prof, top=24):
    """[(op, device ms)] of the host-side ops (aten ops, autograd nodes,
    the port's Functions) by the device time of the kernels each launched
    itself (``self_device_time_total``), largest first."""
    from torch.autograd import DeviceType

    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU
            and not e.key.startswith("step: ")]
    return sorted([r for r in rows if r[1] > 0], key=lambda r: -r[1])[:top]


def _gemm_cuh_us(rows):
    """Device us of ``csrc/gemm.cuh``'s kernels (its GEMM tile and the
    split-K sums) among the profiler's rows."""
    return sum(us for name, us in rows
               if "::gemm_kernel<" in name or "::gemm_tc_kernel<" in name
               or "::sum_splits" in name)


def _attention_fwd_us(rows):
    """Device us of #1's attention kernels (both routes, f32 and bf16)
    and of the flash forward (#4, #5; f32 and bf16) among the profiler's
    rows: (#1, the flash forward)."""
    return (sum(us for name, us in rows if "::qkv_cluster_" in name
                or "::qkv_tiles_fwd_kernel<" in name),
            sum(us for name, us in rows if "::flash_fwd_kernel<" in name
                or "::flash_fwd_tc_kernel<" in name))


def _walks_us(rows):
    """Device us of the backward walks (``csrc/flash_walk.cuh``'s dq and
    dkv kernels, in every layout and inside the f32 pair; the tensor-core
    walks of ``csrc/flash_bwd_tc.cuh``, the bf16 pair's and #6's and #7's
    in bf16) among the profiler's rows."""
    return sum(us for name, us in rows
               if "flash_bwd_dq_kernel<" in name
               or "flash_bwd_dkv_kernel<" in name
               or "::bwd_dq_tc_kernel<" in name
               or "::bwd_dkv_tc_kernel<" in name
               or "::flash_dq_tc_kernel<" in name
               or "::flash_dkv_tc_kernel<" in name)


#: fragments of the conv + BN kernels' names (f32 and bf16) in a profile:
#: #19 in bf16 is the ResNet step's only gemm_tc_kernel
CONV_BN_KERNELS = {"#18": ("channel_stats_kernel<",),
                   "#19": ("dot_stats_kernel", "gemm_tc_kernel<"),
                   "#20": ("ssa_fwd_kernel<", "ssa_fwd_scalar_kernel<",
                           "ssa_fwd_walk_kernel<"),
                   "#21": ("ssa_bwd_kernel<",),
                   "reduce_partials": ("reduce_partials",)}
#: the ops whose kernels are cuDNN's convolutions and cuBLAS's GEMMs (the
#: 1x1 sites' backward products, the classifier) in a ResNet step, by the
#: op that launched them (kernel names do not tell cuDNN's GEMMs from
#: cuBLAS's)
CUDNN_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")
CUBLAS_OPS = ("aten::mm", "aten::addmm", "aten::bmm")


def resnet_bn_sites(batch):
    """(rows, C, residual, relu, 3x3) of the 53 conv + BN sites of one
    ResNet-50 forward at ``batch`` images of RESNET_SIZE: #20 and #21 run
    at each, #18 where the convolution is not 1x1 (the stem, each
    bottleneck's conv2)."""
    stem = batch * (RESNET_SIZE // 2) ** 2
    sites, side = [(stem, 64, False, True, True)], RESNET_SIZE // 4
    for blocks, mid, out, stride in RESNET50_STAGES:
        for blk in range(blocks):
            side_out = side // (stride if blk == 0 else 1)
            rows = batch * side_out ** 2
            if blk == 0:
                sites.append((rows, out, False, False, False))
            sites += [(rows, mid, False, True, False),
                      (rows, mid, False, True, True),
                      (rows, out, True, True, False)]
            side = side_out
    return sites


def resnet_bf16_bounds(batch):
    """{kernel: summed bf16 bound ms of one amp step's sites}: #18 at the
    17 non-1x1 sites, #19 at the 36 1x1 sites, #20 and #21 at all 53."""
    sites = resnet_bn_sites(batch)
    return {
        "#18": sum(bound_bf16(3 * r * c, BF16 * r * c + F32 * 2 * c)[0]
                   for r, c, _, _, kxk in sites if kxk),
        "#19": sum(dot_stats_bf16_bound_ms(*site)
                   for site in resnet_dot_sites(batch)),
        "#20": sum(bound_bf16((2 + res + relu) * r * c,
                              BF16 * (2 + res) * r * c + F32 * 2 * c)[0]
                   for r, c, res, relu, _ in sites),
        "#21": sum(bound_bf16((4 + relu) * r * c,
                              BF16 * (3 + relu + res) * r * c
                              + F32 * 3 * c)[0]
                   for r, c, res, relu, _ in sites)}


def profile_resnet(model, tag="f32"):
    """Device time by kernel over one ResNet-50 step at RESNET_BATCH
    (forward, backward, Momentum), beside host wall time; the table goes
    to ``profile_resnet_step[_<tag>].txt``.  Also lists every device kernel
    whose name says it converts layouts (NCHW/NHWC or a transpose), and
    sums cuDNN's and cuBLAS's kernels (by launching op: CUDNN_OPS,
    CUBLAS_OPS), PyTorch's elementwise and reduction kernels and
    each conv + BN kernel (CONV_BN_KERNELS); an amp step (``tag``
    "amp_bf16") also gives each of #18-#21's summed bf16 bound."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import Momentum

    opt = Momentum(model.parameters(), RESNET_LR, RESNET_MOMENTUM)
    feed = _to(resnet_batch(RESNET_BATCH, seed=2), "cuda")
    opt.minimize(model(**feed)[0])  # warm: the allocator and the state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.minimize(model(**feed)[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_kernels(prof)
    busy_us = sum(us for _, us in rows)
    name = "profile_resnet_step" + ("" if tag == "f32" else f"_{tag}")
    with open(os.path.join(OUT_DIR, name + ".txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=80))
    layout = [(name[:80], us / 1e3) for name, us in rows
              if any(k in name.lower() for k in ("nchw", "nhwc",
                                                 "transpose"))]
    conv_bn = {k: sum(us for name, us in rows
                      if any(f in name for f in frags)) / 1e3
               for k, frags in CONV_BN_KERNELS.items()}
    by_op = _op_device_ms(prof, top=len(rows) + 1000)
    out = dict(tag=tag, wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               idle_share=1 - busy_us / wall_us if busy_us else None,
               conv_bn_ms=conv_bn,
               cudnn_ms=sum(ms for op, ms in by_op if op in CUDNN_OPS),
               cublas_ms=sum(ms for op, ms in by_op if op in CUBLAS_OPS),
               by_op=by_op[:12],
               elementwise_ms=sum(us for _, us in _elementwise(rows)) / 1e3,
               elementwise=[(name[:120], us / 1e3)
                            for name, us in _elementwise(rows)[:8]],
               top=[(name[:60], us / 1e3) for name, us in rows[:16]],
               layout_kernels=layout)
    # #19 in the step: its 36 launches' device time beside the summed
    # bound of the 36 sites
    dot_ms = conv_bn["#19"]
    if tag == "f32":
        dot_bound = sum(dot_stats_bound_ms(*site)
                        for site in resnet_dot_sites(RESNET_BATCH))
    else:
        bounds = resnet_bf16_bounds(RESNET_BATCH)
        dot_bound = bounds["#19"]
        out["bf16_bound_ms"] = bounds
        out["bf16_bound_share"] = {k: b / conv_bn[k] if conv_bn[k] else None
                                   for k, b in bounds.items()}
    out.update(dot_stats_ms=dot_ms, dot_stats_bound_ms=dot_bound,
               dot_stats_bound_share=dot_bound / dot_ms if dot_ms else None)
    return out


def profile_deepfm(model):
    """Device time by kernel over one DeepFM step (forward, backward, lazy
    Adam) at DEEPFM_BATCH, beside host wall time; the table goes to
    ``profile_deepfm_step.txt``."""
    from torch.profiler import ProfilerActivity, profile

    opt = _deepfm_adam(model)
    feed = deepfm_batches(DEEPFM_HASH, 1)[0]
    opt.minimize(model(*feed)[0])  # warm: the allocator and the state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.minimize(model(*feed)[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_kernels(prof)
    busy_us = sum(us for _, us in rows)
    with open(os.path.join(OUT_DIR, "profile_deepfm_step.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))

    def ms(word):
        return sum(us for n, us in rows if word in n.lower()) / 1e3

    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                idle_share=1 - busy_us / wall_us if busy_us else None,
                top=[(name[:60], us / 1e3) for name, us in rows[:12]],
                device_kernels=len(rows), gather_ms=ms("gather_kernel"),
                apply_ms=ms("apply_kernel"), sort_ms=ms("sort"))


# ---------------------------------------------------------------------------


def _builds(log, want):
    """Each entry function of the build whose name holds a key of ``want``
    ({kernel: (source or None for any, dynamic shared memory bytes)}): its
    source, template arguments (the mangled name after the kernel's),
    registers, spills and stack (``-Xptxas -v``'s lines of ``log``) and its
    block's dynamic shared memory."""
    import re

    out, src, cur = [], None, None
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].split()[0]
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = None
            for kernel, (source, smem) in want.items():
                if kernel in m.group(1) and source in (None, src):
                    args = m.group(1).split(kernel, 1)[1]
                    cur = dict(kernel=kernel, source=src,
                               template=args[:args.find("EE") + 2]
                               if args.startswith("I") else "",
                               layout=("bhtd" if "Bhtd" in args else "bthd")
                               if "flash" in kernel else None,
                               dtype="bf16" if "bfloat16" in args
                               or "_tc_" in kernel else "f32",
                               dropout="Lb1E" in args and (
                                   "flash" in kernel or "qkv" in kernel
                                   or kernel.startswith("bwd_")),
                               smem_bytes=smem(args) if callable(smem)
                               else smem)
                    out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if cur is not None and m:
            cur.update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if cur is not None and m:
            cur["registers"] = int(m[1])
    return out


def walk_builds(log, lib):
    """Each instantiation of the backward walks in the build (every source
    that compiles them) and of the bf16 tensor-core kernels (#4's
    forward, #1's cluster route at R 64 and 32, the tile in every source
    that compiles it, the tensor-core walks: the pair's on hi/lo planes in
    qkv_attention_bwd.cu, #6's and #7's on one bf16 plane in
    flash_attention.cu): see ``_builds``."""
    import re

    def tc_smem(args):  # the tile's template: A, B k-major; A, B split
        return lib.ptt_gemm_tc_smem(*(int(f) for f in re.findall(
            r"Lb([01])E", args)[:4]))

    def width(args):  # a kernel's head width, 64 or 128
        return 128 if "Li128E" in args else 64

    def walk(which):
        return lambda args: lib.ptt_flash_walk_smem(which, width(args))

    def pair(which):
        return lambda args: lib.ptt_qkv_bwd_walk_smem(which, width(args))

    return _builds(log, {
        "flash_bwd_dq_kernel": (None, walk(0)),
        "flash_bwd_dkv_kernel": (None, walk(1)),
        "flash_fwd_tc_kernel": ("flash_attention.cu", walk(3)),
        "qkv_cluster_tc_kernel": ("qkv_attention.cu", lambda args:
                                  lib.ptt_qkv_cluster_smem(
                                      64 if args.startswith("ILi64") else 32,
                                      1, width(args))),
        "gemm_tc_kernel": (None, tc_smem),
        "bwd_dq_tc_kernel": ("qkv_attention_bwd.cu", pair(0)),
        "bwd_dkv_tc_kernel": ("qkv_attention_bwd.cu", pair(1)),
        "flash_dq_tc_kernel": ("flash_attention.cu", walk(4)),
        "flash_dkv_tc_kernel": ("flash_attention.cu", walk(5))})


def head128_builds(log, lib):
    """The instantiations of the kernels compiled for head widths 64 and
    128 (#1's f32 cluster and tiles kernels, the megastep, flash-decode):
    see ``_builds``; the template's last integer is the head width (the
    first, flash-decode's)."""
    import re

    def cluster_smem(args):  # <R, DROP, D>
        r, dh = (int(n) for n in re.findall(r"Li(\d+)E", args)[:2])
        return lib.ptt_qkv_cluster_smem(r, 0, dh)

    return _builds(log, {
        "qkv_cluster_fwd_kernel": ("qkv_attention.cu", cluster_smem),
        "qkv_tiles_fwd_kernel": ("qkv_attention.cu", None),
        "megastep_kernel": ("megastep.cu", None),
        "decode_kernel": ("decode_attention.cu", None)})


#: the kernels behind a head-width-128 training counter, by dtype: (their
#: source, their names); bf16 on tensor cores, f32 on the CUDA cores (the
#: pair's walks are flash_walk.cuh's, instantiated in its own source)
HEAD128_TRAIN_KERNELS = {
    torch.bfloat16: {
        "qkv_attention_fwd": ("qkv_attention.cu",
                              ("qkv_cluster_tc_kernel",)),
        "qkv_bwd_dq": ("qkv_attention_bwd.cu", ("bwd_dq_tc_kernel",)),
        "qkv_bwd_dkv": ("qkv_attention_bwd.cu", ("bwd_dkv_tc_kernel",)),
        "flash_fwd": ("flash_attention.cu", ("flash_fwd_tc_kernel",)),
        "flash_bwd_dq": ("flash_attention.cu", ("flash_dq_tc_kernel",)),
        "flash_bwd_dkv": ("flash_attention.cu", ("flash_dkv_tc_kernel",))},
    torch.float32: {
        "qkv_attention_fwd": ("qkv_attention.cu",
                              ("qkv_cluster_fwd_kernel",)),
        "qkv_bwd_dq": ("qkv_attention_bwd.cu", ("flash_bwd_dq_kernel",)),
        "qkv_bwd_dkv": ("qkv_attention_bwd.cu", ("flash_bwd_dkv_kernel",)),
        "flash_fwd": ("flash_attention.cu", ("flash_fwd_kernel",)),
        "flash_bwd_dq": ("flash_attention.cu", ("flash_bwd_dq_kernel",)),
        "flash_bwd_dkv": ("flash_attention.cu", ("flash_bwd_dkv_kernel",))}}


def blocks_per_sm(registers, smem_bytes, threads):
    """Blocks of a kernel an H100 SM holds at once, from its registers a
    thread (allocated 256 a warp at a time of 64 K), its dynamic shared
    memory (228 KB an SM, 1 KB reserved a block) and its threads (2048 an
    SM)."""
    warps = -(-threads // 32)
    by_registers = 65536 // (-(-registers * 32 // 256) * 256) // warps
    by_smem = 233472 // (smem_bytes + 1024)
    return min(by_registers, by_smem, 2048 // threads, 32)


def head128_train_builds(builds, counter):
    """The head-width-128 instantiations behind a ``_dh128`` training
    counter (``_bf16_dh128`` in bf16) in a list of ``_builds`` records
    (``walk_builds``, ``tile_builds`` and ``head128_builds``'): each with
    its registers, spills, shared memory, threads and blocks an SM
    (:func:`blocks_per_sm`)."""
    from paddle_tpu_torch.kernels import KERNEL_DTYPES

    dtype = torch.bfloat16 if "_bf16" in counter else torch.float32
    name = counter[:-len(KERNEL_DTYPES[dtype] + "_dh128")]
    layout = "bhtd" if "_bhtd" in name else "bthd"
    source, kernels = HEAD128_TRAIN_KERNELS[dtype][name.replace("_bhtd", "")]
    out = []
    for r in builds:
        if (r["kernel"] not in kernels or r["source"] != source
                or "Li128E" not in r["template"]
                or (r["layout"] not in (None, layout))):
            continue
        if r["kernel"] == "qkv_cluster_tc_kernel":
            threads = (64 if r["template"].startswith("ILi64") else 32) * 4
        elif r["kernel"] == "qkv_cluster_fwd_kernel":
            threads = 2 * 128
        elif dtype == torch.float32:  # flash_walk.cuh's walks
            threads = 256
        else:  # the pair's walks: two warps a row group at 128
            threads = 256 if r["kernel"].startswith("bwd_") else 128
        out.append(dict({k: v for k, v in r.items() if k != "source"},
                        threads=threads, blocks_per_sm=blocks_per_sm(
                            r.get("registers", 255), r["smem_bytes"],
                            threads)))
    require(out, f"{counter}: no head-width-128 instantiation in the build")
    return out


def tile_builds(log, lib):
    """The instantiations of #19's kernel, ``gemm.cuh``'s GEMM (as
    ``gemm.cu`` compiles it) and the flash forward (#4, #5): see
    ``_builds``."""
    return _builds(log, {
        "dot_stats_kernel": ("conv_bn.cu", lib.ptt_dot_stats_smem()),
        "gemm_kernel": ("gemm.cu", lib.ptt_gemm_smem()),
        "flash_fwd_kernel": ("flash_attention.cu", lambda args:
                             lib.ptt_flash_walk_smem(
                                 2, 128 if "Li128E" in args else 64))})


def print_record(r, label):
    """Print a phase-2 record and append it to phase2_records.jsonl in
    OUT_DIR (stdout's tail may not reach back to phase 2)."""
    with open(os.path.join(OUT_DIR, "phase2_records.jsonl"), "a") as f:
        f.write(json.dumps(dict(r, label=label)) + "\n")
    print(f"phase 2: {r['name']}{label}: max_abs_err "
          f"{r['max_abs_err']:.3e} ms {r['ms']} plain_ms {r['plain_ms']} "
          f"bound_ms {r['bound_ms']} ({r['bound_by']}) library_ms "
          f"{r['library_ms']}"
          + (f" (library max_abs_err {r['library_max_abs_err']:.3e})"
             if "library_max_abs_err" in r else "")
          + (f"; rate {DROPOUT}: ms {r['dropout_ms']} bound_ms "
             f"{r['dropout_bound_ms']} max_abs_err "
             f"{r['dropout_max_abs_err']:.3e}" if "dropout_ms" in r else "")
          + (f"; bare product (torch.matmul) ms {r['matmul_ms']}"
             if "matmul_ms" in r else "")
          + (f"; {r['tflops']:.2f} TFLOP/s, {r['peak_share']:.1%} of the "
             f"f32 peak (torch.matmul {r['matmul_tflops']:.2f})"
             if "tflops" in r else "")
          + (f"; strided rows copied in {r['strided_copy_ms']} ms"
             if "strided_copy_ms" in r else "")
          + (f"; sums {r['sum_err_of_terms']:.3e} of their terms (TOL_SUM "
             f"{TOL_SUM})" if "sum_err_of_terms" in r else "")
          + (f"; with the host's enqueue {r['call_ms']} ms"
             if "call_ms" in r else "")
          + (f"; device only {r['device_ms']} ms"
             if "device_ms" in r else "")
          + (f" (the library call {r['library_device_ms']} ms)"
             if "library_device_ms" in r else "")
          + (f"; {r['off_rounding_share']:.3%} off the float64 value "
             "rounded to bf16" if isinstance(r.get("off_rounding_share"),
                                             float) else "")
          + (f"; shares off the float64 value rounded to bf16 (the tree's "
             f"and the parent's outputs) {r['off_rounding_share']}"
             if isinstance(r.get("off_rounding_share"), dict) else "")
          + (f"; 26 F.embedding calls {r['embedding_x26_ms']} ms"
             if "embedding_x26_ms" in r else "")
          + (f"; twin's bits: {r['twin_bit_equal']}"
             if "twin_bit_equal" in r else "")
          + (f"; the parent's kernel {r['parent_ms']} ms"
             + (f", rate {DROPOUT} {r['parent_dropout_ms']} ms"
                if r.get("parent_dropout_ms") is not None else "")
             + (f", device only {r['parent_device_ms']} ms"
                if r.get("parent_device_ms") is not None else "")
             if r.get("parent_ms") is not None else "")
          + (f"; {r['same_bytes']}: {r['same_bytes_ms']} ms, device only "
             f"{r['same_bytes_device_ms']} ms" if "same_bytes" in r else "")
          + (f"; without a residual {r['no_residual_ms']} ms, device only "
             f"{r.get('no_residual_device_ms')} ms (the parent's "
             f"{r.get('no_residual_parent_device_ms')}), bound "
             f"{r['no_residual_bound_ms']}" if "no_residual_ms" in r else "")
          + (f"; bits held on {r['bit_cases']}" if "bit_cases" in r
             else "")
          + (f"; after a clean flush, device only {r['clean_flush_device_ms']}"
             f" ms (the parent's {r['clean_flush_parent_device_ms']}, the "
             f"same bytes {r['clean_flush_same_bytes_device_ms']})"
             if "clean_flush_device_ms" in r else "")
          + (f"; a stable torch.sort of its ids {r['sort_ms']} ms, longest "
             f"run {r['run_max']}" if "sort_ms" in r else "")
          + (f"; {r['bound_share']:.1%} of the bound"
             if "bound_share" in r else "")
          + (f"; the head-width-64 instantiation on the same bytes "
             f"{r['dh64_ms']} ms" + (f", device only {r['dh64_device_ms']}"
                                     if "dh64_device_ms" in r else "")
             if "dh64_ms" in r else "")
          + (f"; plan {r['plan']}, co-resident grid "
             f"{r['co_resident_grid']} ({r['blocks_per_sm']} an SM)"
             if "co_resident_grid" in r else "")
          + (f"; the walks' own bound (s, dp twice) {r['walks_bound_ms']} "
             f"ms; {r['library_factor']:.3f}x the library"
             if "library_factor" in r else ""))


class _Tee:
    """stdout copied into a file of OUT_DIR: the command's tail that the
    caller sees may not reach back to phases 2 and 3."""

    def __init__(self, stream, path):
        self.stream, self.file = stream, open(path, "w")

    def write(self, text):
        self.file.write(text)
        return self.stream.write(text)

    def flush(self):
        self.file.flush()
        self.stream.flush()


#: a phase-3 record's fields that its summary shows, where it has them
SUMMARY_KEYS = ("route", "batch", "prefill_ms", "decode_tokens_per_s",
                "requests_per_s", "generated_tokens_per_s", "ttft_ms_p50",
                "step_ms_median", "tokens_per_s", "images_per_s",
                "examples_per_s", "f32_peak_share", "bf16_peak_share",
                "device_busy_ms", "idle_share", "peak_memory_gb")


def keep_phase3(kept, tag, records):
    """Write each of phase 3's ``records`` (one record or a list) to a
    file of its own in OUT_DIR (``phase3_<tag>.json``, ``_<i>`` after the
    tag in a list) as it comes, and append its summary to ``kept`` for
    :func:`print_phase3`: the standard output's tail may not reach back
    to phase 3."""
    many = isinstance(records, list)
    for i, r in enumerate(records if many else [records]):
        name = f"phase3_{tag}{f'_{i}' if many else ''}.json"
        with open(os.path.join(OUT_DIR, name), "w") as f:
            json.dump(r, f, indent=1, default=str)
        kept.append((tag, {k: r[k] for k in SUMMARY_KEYS if k in r}))


def print_phase3(kept):
    """One short line a kept phase-3 record (at most 300 characters): its
    summary fields, the whole record being in its file."""
    for tag, summary in kept:
        line = json.dumps(summary, default=str)
        print(f"phase 3 {tag}: {line[:280]}")


def _phase_seconds(label, t0):
    """Print a phase's seconds; returns the time it ended."""
    now = time.perf_counter()
    print(f"{label}: {now - t0:.1f} s")
    return now


def main():
    parser = argparse.ArgumentParser(description="Smoke run of "
                                     "paddle_tpu_torch on one CUDA card.")
    parser.add_argument(
        "--parent", metavar="ROOT", help="another checkout of this "
        "repository (the parent commit, unpacked by git archive): its "
        "kernels are built beside this tree's, timed beside the redesigned "
        "bf16 kernels, held bit for bit against the kernels this tree "
        "keeps, and profiled in the amp step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch
        from paddle_tpu_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: paddle_tpu_torch not found beside the script "
              f"({exc})", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    sys.stdout = _Tee(sys.stdout, os.path.join(OUT_DIR,
                                               "chip_smoke_stdout.log"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    if args.parent:
        start_parent_build(args.parent)
    _build.lib()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s; the host gives this process "
          f"{len(os.sched_getaffinity(0))} of {os.cpu_count()} CPUs, torch "
          f"{torch.get_num_threads()} threads")
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_build.build_log())
    open(os.path.join(OUT_DIR, "phase2_records.jsonl"), "w").close()
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "== " in line:
            print("  " + line.strip())
    builds = walk_builds(_build.build_log(), _build.lib())
    tiles = tile_builds(_build.build_log(), _build.lib())
    widths = head128_builds(_build.build_log(), _build.lib())
    for r in builds + tiles + widths:
        print(f"phase 1: {r}")
    # the head-width-128 instantiations of the serving path are built
    require(all(any(r["kernel"] == kernel and "Li128E" in r["template"]
                    for r in widths)
                for kernel in ("qkv_cluster_fwd_kernel",
                               "qkv_tiles_fwd_kernel", "megastep_kernel",
                               "decode_kernel")),
            "a head-width-128 instantiation is missing from the build")
    # bf16 operands of #6 and #7 reach the tensor-core walks only
    require(not any(r["kernel"] in ("flash_bwd_dq_kernel",
                                    "flash_bwd_dkv_kernel",
                                    "flash_fwd_kernel")
                    and r["dtype"] == "bf16" for r in builds + tiles),
            "a bf16 instantiation of flash_walk.cuh's walks is in the build")
    mma = sass_mma(_build)
    for fn, n in mma.items():
        print(f"phase 1: SASS of {fn}: {n} HMMA/HGMMA instructions")
    registers = None
    if args.parent:
        parent_lib()
        print(f"phase 1: the parent's kernels ({args.parent}) built in "
              f"{time.perf_counter() - t0:.1f} s")
        registers = parent_registers(_build.build_log())
        print(f"phase 1: registers against the parent's: {registers}")

    gen = torch.Generator().manual_seed(0)
    records = {}
    flash_decode_sides = {"flash_decode": {}, "flash_decode_paged": {}}
    t_phase = time.perf_counter()
    for b in BATCHES:
        rec = check_qkv_attention(gen, b)
        mega, ffn = check_decode_kernels(gen, b)
        mega_paged, ffn_paged = check_paged_decode_kernels(gen, b)
        decode = check_flash_decode(gen, b)
        torch.cuda.synchronize()
        checked = [(None, r) for r in (rec, mega, ffn, mega_paged,
                                        ffn_paged)]
        checked += [(side, r) for (_, side), r in decode.items()]
        for (name, side), r in decode.items():
            flash_decode_sides[name].setdefault(b, []).append((side, r))
        for side, r in checked:
            print_record(r, f"{' ' + side if side else ''} b={b}")
            # the JSON line carries the cross side of the flash-decode pair
            if side in (None, "cross"):
                records[(r["name"], b)] = r
    # the megastep and FFN records in the JSON line carry b=1's, the
    # ragged b=33's and (the megastep's) the full caches'
    for name in ("megastep", "megastep_paged", "ffn", "ffn_paged"):
        records[(name, max(BATCHES))]["cases"] = {
            "b=1": {k: records[(name, 1)][k] for k in MEGASTEP_CASE_KEYS}}
    for (name, case), r in check_megastep_cases().items():
        print_record(r, f" {case}")
        records[(name, max(BATCHES))]["cases"][case] = {
            k: r[k] for k in MEGASTEP_CASE_KEYS}
    # the flash-decode records in the JSON line carry b=1's cross side,
    # the self sides, the ragged b=33's and the full caches'
    for name in ("flash_decode", "flash_decode_paged"):
        records[(name, max(BATCHES))]["cases"] = {
            f"{side} b={b}": {k: r[k] for k in FLASH_DECODE_CASE_KEYS}
            for b in BATCHES for side, r in flash_decode_sides[name][b]
            if (side, b) != ("cross", max(BATCHES))}
    for (name, case), r in check_flash_decode_cases().items():
        print_record(r, f" {case}")
        records[(name, max(BATCHES))]["cases"][case] = {
            k: r[k] for k in FLASH_DECODE_CASE_KEYS}
    for (name, case), r in check_flash_attention(gen).items():
        print_record(r, f" {case} b={r['batch']}")
        if case == FLASH_RECORD_CASE:
            records[(name, max(BATCHES))] = r
    for (name, case), r in check_flash_attention_bhtd(gen).items():
        print_record(r, f" {case} b={r['batch']}")
        if case == BHTD_RECORD_CASE:
            records[(name, max(BATCHES))] = r
    # both walks of a layout in one call sequence, at the record case
    flash_bwd = {"bthd": records.pop(("flash_bwd", max(BATCHES))),
                 "bhtd": records.pop(("flash_bwd_bhtd", max(BATCHES)))}
    # the walks' records in the JSON line carry their builds
    for name, layout in (("flash_bwd_dq", "bthd"), ("flash_bwd_dkv", "bthd"),
                         ("flash_bwd_dq_bhtd", "bhtd"),
                         ("flash_bwd_dkv_bhtd", "bhtd")):
        kernel = name.replace("_bhtd", "") + "_kernel"
        records[(name, max(BATCHES))]["build"] = [
            {k: v for k, v in r.items() if k not in ("kernel", "layout")}
            for r in builds if r["kernel"] == kernel and r["dtype"] == "f32"
            and r["layout"] == layout and r["source"] == "flash_attention.cu"
            and "Li128E" not in r["template"]]
    for name, layout in (("flash_fwd", "bthd"), ("flash_fwd_bhtd", "bhtd")):
        records[(name, max(BATCHES))]["build"] = [
            {k: v for k, v in r.items() if k not in ("kernel", "layout")}
            for r in tiles if r["kernel"] == "flash_fwd_kernel"
            and r["layout"] == layout and r["dtype"] == "f32"
            and "Li128E" not in r["template"]]
    pair = {}
    for (name, case), r in check_qkv_training(gen).items():
        residuals = " (residuals)" if name == "qkv_attention_fwd" else ""
        print_record(r, f"{residuals} {case} b={r['batch']}")
        if name == "qkv_bwd":
            pair[case] = r
            for rate, parts in r.get("vs_float64", {}).items():
                print(f"phase 2: qkv_bwd {case} rate {rate}: max abs err "
                      f"against float64 (kernel, f32 twin) and the "
                      f"kernel's excess over TOL_KERNEL against the twin: "
                      f"{parts}")
            continue
        # #1's record in the JSON line stays the serving one (b=64), with
        # the training step's residual mode (its own batch, rate 0 and
        # rate 0.1) beside it
        if case == QKV_RECORD_CASE and not residuals:
            records[(name, max(BATCHES))] = r
        if case == QKV_RECORD_CASE and residuals:
            records[(name, max(BATCHES))]["residual"] = {
                k: r[k] for k in ("batch", "ms", "plain_ms", "bound_ms",
                                  "library_ms", "max_abs_err", "dropout_ms",
                                  "dropout_bound_ms", "dropout_max_abs_err")}
    # #2's and #3's records in the JSON line carry the pair's (the
    # autograd backward's one call) at the record case and at BERT-base's
    pair_keys = ("batch", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "max_abs_err", "dropout_ms",
                 "dropout_bound_ms", "dropout_max_abs_err", "vs_float64")
    for name in ("qkv_bwd_dq", "qkv_bwd_dkv"):
        records[(name, max(BATCHES))]["pair"] = {
            case: {k: pair[case][k] for k in pair_keys if k in pair[case]}
            for case in (QKV_RECORD_CASE, QKV_PAIR_BERT[0])}
    gemm_records = check_gemm(gen)
    for r in gemm_records:
        # the instantiation of its operand layouts; #1's y, the tensor-core
        # tile's
        r["build"] = [{k: v for k, v in t.items() if k != "kernel"}
                      for t in tiles if t["kernel"] == "gemm_kernel"
                      and t["template"].startswith(
                          f"ILb{int(r['a_kmajor'])}ELb{int(r['b_kmajor'])}E")
                      and (t["dtype"] == "bf16") == ("dtypes" in r)]
        if r.get("dtypes") == ["bfloat16"] * 3 and not r["a_kmajor"]:
            r["build"] = [{k: v for k, v in t.items() if k != "kernel"}
                          for t in builds if t["kernel"] == "gemm_tc_kernel"]
        print_record(r, f" {r['case']} (M {r['m']}, N {r['n']}, K "
                        f"{r['k']})")
    plans = check_qkv_plans(gen)
    for case, r in plans.items():
        print_record(r, f" (residuals) {case} b={r['batch']} plan "
                        f"{tuple(r['plan'])}")
    # #1's record in the JSON line carries every plan's case beside it
    records[("qkv_attention_fwd", max(BATCHES))]["plans"] = {
        case: {k: r[k] for k in ("plan", "batch", "t", "ms", "plain_ms",
                                 "bound_ms", "library_ms", "max_abs_err",
                                 "dropout_ms", "dropout_max_abs_err",
                                 "device_ms")}
        for case, r in plans.items()}
    print(f"phase 2: head widths 128 and 192 on the card, by kernel and "
          f"dtype: {check_head_width_128(gen)}")
    # C2 part 1: the serving path's kernels at head width 128 (BIG's
    # widths) beside their head-width-64 instantiations on the same bytes
    t_128 = time.perf_counter()
    head128, head128_cases = check_head128_kernels()
    for r in head128_cases:
        print_record(r, f" d_model {BIG['d_model']} {r['case']}")
    for name, r in head128.items():
        if name.startswith("ffn"):
            # the FFN has no head axis: its d_model-1024 cases ride on
            # its own record
            records[(name[:-len("_dm1024")], max(BATCHES))]["dm1024"] = {
                case: {k: c[k] for k in HEAD128_CASE_KEYS if k in c}
                for case, c in dict(r["cases"], **{r["case"]: r}).items()}
        else:
            records[(name, max(BATCHES))] = r
    _phase_seconds("phase 2: head width 128", t_128)
    # C2 part 2: the training kernels at head width 128 (BIG's widths), in
    # bf16 (amp, part 2a) and in f32 (part 2b), beside their head-width-64
    # instantiations on the same bytes, with their builds (registers,
    # spills, shared memory, blocks an SM)
    for dtype, seed in ((torch.bfloat16, 25), (torch.float32, 26)):
        t_128 = time.perf_counter()
        suffix = paddle_tpu_torch.kernels.KERNEL_DTYPES[dtype] + "_dh128"
        train128, train128_cases = check_head128_train_kernels(dtype, seed)
        for r in train128_cases:
            if "ms" in r:
                print_record(r, f" d_model {BIG['d_model']} {r['case']}")
                continue
            with open(os.path.join(OUT_DIR, "phase2_records.jsonl"),
                      "a") as f:
                f.write(json.dumps(r) + "\n")
            print(f"phase 2: {r['name']} d_model {BIG['d_model']} "
                  f"{r['case']} b={r['batch']}: max_abs_err "
                  f"{r['max_abs_err']:.3e}, rate {DROPOUT} "
                  f"{r['dropout_max_abs_err']:.3e}"
                  + (f", plan {r['plan']}" if "plan" in r else ""))
        for name, r in train128.items():
            r["build"] = head128_train_builds(builds + tiles + widths, name)
            if name == "qkv_attention_fwd_dh128":
                # #1's f32 record at 128 is the serving one (phase 2's
                # head width 128), with the training step's residual mode
                # beside it
                records[(name, max(BATCHES))]["residual"] = r
            else:
                records[(name, max(BATCHES))] = r
        # #5, #8 and #9 at 128 run on no model's path (no model of head
        # width 128 takes the bhtd layout): their records ride on the bthd
        # kernels'
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            records[(name + suffix, max(BATCHES))]["bhtd"] = records.pop(
                (name + "_bhtd" + suffix, max(BATCHES)))
        _phase_seconds(f"phase 2: {dtype} training at head width 128",
                       t_128)
    for r in check_dropout_add(gen):
        print_record(r, f" [{DROPOUT_ROWS}, {BASE['d_model']}] rate "
                        f"{DROPOUT}")
        records[(r["name"], max(BATCHES))] = r
    # the bf16 instantiations (amp) at the amp step's shapes, and at
    # BERT-base's (the bhtd kernels; #1 and the pair)
    amp_records = {**check_qkv_bf16(gen), **check_flash_attention_bf16(gen),
                   **check_flash_attention_bhtd_bf16(gen)}
    for r in check_dropout_add_bf16(gen):
        amp_records[r["name"]] = r
    for name, r in amp_records.items():
        print_record(r, f" {r.get('case', '')} b={r['batch']}")
        records[(name, max(BATCHES))] = r
    bert_bf16 = check_qkv_bf16_bert(gen)
    for r in bert_bf16.values():
        print_record(r, f" {r['case']} b={r['batch']}")
    # #1's bf16 record in the JSON line carries BERT-base's case, #2's and
    # #3's the pair's there
    bert_keys = ("case", "batch", "t", "d_model", "ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms", "max_abs_err",
                 "dropout_ms", "dropout_bound_ms", "dropout_max_abs_err",
                 "device_ms", "library_device_ms", "off_rounding_share")
    records[("qkv_attention_fwd_bf16", max(BATCHES))]["bert"] = dict(
        {k: bert_bf16["qkv_attention_fwd"][k] for k in bert_keys},
        plan=bert_bf16["qkv_attention_fwd"]["plan"])
    for name in ("qkv_bwd_dq_bf16", "qkv_bwd_dkv_bf16"):
        records[(name, max(BATCHES))]["pair_bert"] = {
            k: bert_bf16["qkv_bwd"][k] for k in bert_keys}
    gelu = check_gelu_bf16()
    print(f"phase 2: gelu bf16 (the reference's arithmetic) on the card "
          f"against the CPU, and F.gelu against it, on every finite bf16 "
          f"input: {gelu}")
    # the tensor-core kernels' records carry their builds and SASS (the
    # pair's, with its GEMM stages, on #2's and #3's records)
    for name, source, kernels in (
            ("flash_fwd_bf16", "flash_attention.cu", ("flash_fwd_tc_kernel",)),
            ("flash_bwd_dq_bf16", "flash_attention.cu",
             ("flash_dq_tc_kernel",)),
            ("flash_bwd_dkv_bf16", "flash_attention.cu",
             ("flash_dkv_tc_kernel",)),
            ("flash_fwd_bhtd_bf16", "flash_attention.cu",
             ("flash_fwd_tc_kernel",)),
            ("flash_bwd_dq_bhtd_bf16", "flash_attention.cu",
             ("flash_dq_tc_kernel",)),
            ("flash_bwd_dkv_bhtd_bf16", "flash_attention.cu",
             ("flash_dkv_tc_kernel",)),
            ("qkv_attention_fwd_bf16", "qkv_attention.cu",
             ("qkv_cluster_tc_kernel", "gemm_tc_kernel")),
            ("qkv_bwd_dq_bf16", "qkv_attention_bwd.cu",
             ("bwd_dq_tc_kernel", "gemm_tc_kernel")),
            ("qkv_bwd_dkv_bf16", "qkv_attention_bwd.cu",
             ("bwd_dkv_tc_kernel", "gemm_tc_kernel"))):
        # the flash kernels' builds of the record's layout
        layout = ("bhtd" if "_bhtd" in name else "bthd"
                  if name.startswith("flash") else None)
        records[(name, max(BATCHES))]["build"] = [
            dict({k: v for k, v in t.items() if k != "source"},
                 sass_mma=sum(n for fn, n in mma.items()
                              if fn.startswith(source + ":")
                              and t["kernel"] in fn and t["template"] in fn))
            for t in builds if t["kernel"] in kernels
            and t["source"] == source
            and (layout is None or t["layout"] == layout)]
    parent_bits = check_parent_bits(torch.Generator().manual_seed(18))
    if parent_bits is not None:
        print(f"phase 2: {len(parent_bits)} calls give the parent's bits: "
              f"{parent_bits}")
    # the JSON line carries each conv + BN kernel's first case
    for (name, case), r in check_conv_bn(gen).items():
        print_record(r, f" {case} b={r['batch']}")
        records.setdefault((name, max(BATCHES)), r)
    records[("dot_col_stats", max(BATCHES))]["build"] = [
        {k: v for k, v in t.items() if k != "kernel"}
        for t in tiles if t["kernel"] == "dot_stats_kernel"]
    # #18-#21 in bf16 (amp): the JSON line carries each one's first case
    t_bf16 = time.perf_counter()
    for (name, case), r in check_conv_bn_bf16(gen).items():
        print_record(r, f" {case} b={r['batch']}")
        records.setdefault((name, max(BATCHES)), r)
    print(f"phase 2: conv + BN calls refused on the card, before any "
          f"launch: {check_conv_bn_refusals(gen)}")
    _phase_seconds("phase 2: conv + BN in bf16", t_bf16)
    # ... and each embedding kernel's first: #22 on the emb group, #23 in
    # Adam mode on it
    for r, label in check_embedding():
        print_record(r, label)
        records.setdefault((r["name"], max(BATCHES)), r)
    t_phase = _phase_seconds("phase 2", t_phase)
    phase3 = []  # each phase-3 record's summary, printed before the kernels

    model = paddle_tpu_torch.Transformer(**BASE).init_params(seed=0)
    cpu_model = paddle_tpu_torch.Transformer(**BASE, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    unfused = paddle_tpu_torch.Transformer(**BASE, fused_decode_step=False)
    unfused.load_state_dict(model.state_dict())
    L = BASE["n_layer"]
    runs = []
    for b in BATCHES:
        run, tokens, logits = run_main_path(model, cpu_model, b)
        runs.append(run)
        src = source_batch(b, seed=b)
        for paged in (False, True):
            walk = "flash_decode_paged" if paged else "flash_decode"
            runs.append(run_route(
                unfused, b, src, tokens, logits,
                expected(qkv_attention_fwd=L, **{walk: 2 * L * MAX_OUT}),
                f"{'paged' if paged else 'ring'} unfused", paged=paged))
        if b == max(BATCHES):
            runs.append(run_route(
                model, b, src, tokens, logits,
                expected(qkv_attention_fwd=L, megastep_paged=L * MAX_OUT,
                         ffn=L * MAX_OUT), "paged fused", paged=True))
        del logits
        torch.cuda.synchronize()
    for run in runs:
        print(f"phase 3: {run['route']} b={run['batch']}: prefill "
              f"{run['prefill_ms']} ms (median of 5, range "
              f"{run['prefill_ms_range']}), decode "
              f"{run['decode_tokens_per_s']} tokens/s "
              f"({run['decode_ms_per_step']} ms/step mean, p50 "
              f"{run['step_ms_p50']}, p80 {run['step_ms_p80']} of "
              f"{MAX_OUT}), launches {run['launches']}, logits max_abs_err "
              f"{run['logits_max_abs_err']:.3e}, argmax held on "
              f"{run['argmax_checked']}/{run['argmax_total']} clear steps")
    keep_phase3(phase3, "main_path", runs)

    serving = []
    for paged in (False, True):
        stats, results, prompts = run_serving(model, paged)
        stats["sampled_argmax"] = check_sampled(model, prompts, results)
        print(f"phase 3: {stats['route']}: " + ", ".join(
            f"{k} {v}" for k, v in stats.items() if k != "route"))
        serving.append(stats)
    keep_phase3(phase3, "c_serving", serving)

    del cpu_model, unfused
    t_phase = _phase_seconds("phase 3 (main), (a)-(c)", t_phase)

    # (m): serving at head width 128 on Transformer-big's widths
    big = paddle_tpu_torch.Transformer(**BIG).init_params(seed=0)
    runs_128, serving_128 = run_head128(big)
    for run in runs_128:
        print(f"phase 3 (m): {run['route']} b={run['batch']}: prefill "
              f"{run['prefill_ms']} ms (median of 5, range "
              f"{run['prefill_ms_range']}), decode "
              f"{run['decode_tokens_per_s']} tokens/s "
              f"({run['decode_ms_per_step']} ms/step mean, p50 "
              f"{run['step_ms_p50']}, p80 {run['step_ms_p80']}), launches "
              f"{ {k: v for k, v in run['launches'].items() if v} }, logits "
              f"max_abs_err {run['logits_max_abs_err']}, argmax held on "
              f"{run['argmax_checked']}/{run['argmax_total']} clear steps")
    print(f"phase 3 (m): {serving_128['route']}: " + ", ".join(
        f"{k} {v}" for k, v in serving_128.items() if k != "route"))
    keep_phase3(phase3, "m_head128", runs_128)
    keep_phase3(phase3, "m_serving_head128", serving_128)
    for b in BATCHES:
        prof = profile_serving(big, b, tag="_dh128")
        for phase, r in prof.items():
            if r["device_busy_ms"]:
                print(f"phase 3 (m): b={b} ring fused d_head 128 {phase} "
                      f"per {'prefill' if phase == 'prefill' else 'step'}: "
                      f"wall {r['wall_ms']} ms, device busy "
                      f"{r['device_busy_ms']} ms, idle share "
                      f"{r['idle_share']}, the megastep {r['megastep_ms']} "
                      f"ms, the FFN {r['ffn_ms']} ms; top {r['top'][:4]}")
    del big
    torch.cuda.empty_cache()
    t_phase = _phase_seconds("phase 3 (m)", t_phase)

    # (n) amp and (o) f32 training at head width 128 on Transformer-big's
    # widths, on both routes from the same seeded weights
    training_128 = {}
    for letter, dtype, kind in (("n", torch.bfloat16, "amp"),
                                ("o", torch.float32, "f32")):
        big = {"fused": paddle_tpu_torch.Transformer(
            **BIG, dropout_rate=DROPOUT).init_params(seed=0)}
        big["flag_off"] = paddle_tpu_torch.Transformer(
            **BIG, dropout_rate=DROPOUT, fused_qkv_attention=False)
        big["flag_off"].load_state_dict(big["fused"].state_dict())
        if kind == "amp":
            for m in big.values():
                paddle_tpu_torch.amp.enable(m)
        recs = training_128[kind] = run_head128_train(big, dtype)
        big_feed = _to(training_batch(seed=2), DEV)
        tag = "amp_bf16" if kind == "amp" else "f32"
        for r, (route, m) in zip(recs, big.items()):
            prof = profile_training(m, f"{tag}_dh128_{route}", feed=big_feed)
            r.update(device_busy_ms=prof["device_busy_ms"],
                     idle_share=prof["idle_share"], wall_ms=prof["wall_ms"],
                     walks_ms=prof["walks_ms"],
                     gemm_cuh_ms=prof["gemm_cuh_ms"],
                     library_gemm_ms=prof["library_gemm_ms"],
                     profile_top=prof["top"][:8])
            print(f"phase 3 ({letter}): " + ", ".join(
                f"{k} {v}" for k, v in r.items()))
        share = "bf16_peak_share" if kind == "amp" else "f32_peak_share"
        print(f"phase 3 ({letter}): {kind} step at head width 128, fused "
              f"route against flag-off: {recs[0]['step_ms_median']} ms "
              f"against {recs[1]['step_ms_median']} ms, "
              f"{recs[0]['tokens_per_s']} against "
              f"{recs[1]['tokens_per_s']} target tokens/s, {share} "
              f"{recs[0][share]} against {recs[1][share]}")
        keep_phase3(phase3, f"{letter}_training_head128_{kind}", recs)
        del big, big_feed
        torch.cuda.empty_cache()
        t_phase = _phase_seconds(f"phase 3 ({letter})", t_phase)

    train_model = paddle_tpu_torch.Transformer(
        **BASE, fused_qkv_attention=False).init_params(seed=1)
    # (f)'s models start from the same initial weights
    init_state = {k: v.detach().cpu().clone()
                  for k, v in train_model.state_dict().items()}
    # (e)'s model: the default route, from (d)'s initial weights
    fused_train = paddle_tpu_torch.Transformer(**BASE)
    fused_train.load_state_dict(train_model.state_dict())
    cpu_copies = [paddle_tpu_torch.Transformer(
        **BASE, device="cpu", fused_qkv_attention=False).to(dtype)
        for dtype in (torch.float32, torch.float64)]
    for copy in cpu_copies:
        copy.load_state_dict(train_model.state_dict())
    training, parity = run_training(train_model, *cpu_copies)
    del cpu_copies
    print("phase 3: " + ", ".join(f"{k} {v}" for k, v in training.items()))
    keep_phase3(phase3, "d_training", training)
    training_fused = run_training_fused(fused_train, parity)
    del parity
    print("phase 3: " + ", ".join(f"{k} {v}"
                                  for k, v in training_fused.items()))
    keep_phase3(phase3, "e_training_fused", training_fused)
    print(f"phase 3: training step, fused route against flag-off: "
          f"{training_fused['step_ms_median']} ms against "
          f"{training['step_ms_median']} ms, "
          f"{training_fused['tokens_per_s']} against "
          f"{training['tokens_per_s']} target tokens/s, f32 peak share "
          f"{training_fused['f32_peak_share']} against "
          f"{training['f32_peak_share']}")

    # (f): dropout on the default route, and its flag-off and CPU copies
    drop_models = [paddle_tpu_torch.Transformer(
        **BASE, dropout_rate=DROPOUT, fused_qkv_attention=fused)
        for fused in (True, False)]
    drop_cpu = [paddle_tpu_torch.Transformer(
        **BASE, device="cpu", fused_qkv_attention=False,
        dropout_rate=DROPOUT).to(dtype)
        for dtype in (torch.float32, torch.float64)]
    for m in drop_models + drop_cpu:
        m.load_state_dict(init_state)
    amp_parity, training_dropout = run_training_dropout(
        drop_models[0], drop_models[1], *drop_cpu)
    del drop_cpu, drop_models[1]
    print("phase 3: " + ", ".join(f"{k} {v}"
                                  for k, v in training_dropout.items()))
    keep_phase3(phase3, "f_training_dropout", training_dropout)

    # (j): bf16 amp on the default route at dropout 0.1, from the same
    # initial weights, held against (f)'s float64 step
    amp_model = paddle_tpu_torch.Transformer(**BASE, dropout_rate=DROPOUT)
    amp_model.load_state_dict(init_state)
    del init_state
    paddle_tpu_torch.amp.enable(amp_model)
    training_amp = run_training_amp(amp_model, amp_parity)
    del amp_parity
    print("phase 3: " + ", ".join(f"{k} {v}"
                                  for k, v in training_amp.items()))
    keep_phase3(phase3, "j_training_amp", training_amp)
    print(f"phase 3: training step, amp bf16 against f32 (dropout "
          f"{DROPOUT}, fused route): {training_amp['step_ms_median']} ms "
          f"against {training_dropout['step_ms_median']} ms, "
          f"{training_amp['tokens_per_s']} against "
          f"{training_dropout['tokens_per_s']} target tokens/s, bf16 peak "
          f"share {training_amp['bf16_peak_share']} (f32 peak share "
          f"{training_dropout['f32_peak_share']} in f32), peak memory "
          f"{training_amp['peak_memory_gb']} against "
          f"{training_dropout['peak_memory_gb']} GB")
    print(f"phase 3: training step, dropout {DROPOUT} against rate 0 (fused "
          f"route): {training_dropout['step_ms_median']} ms against "
          f"{training_fused['step_ms_median']} ms, "
          f"{training_dropout['tokens_per_s']} against "
          f"{training_fused['tokens_per_s']} target tokens/s, f32 peak "
          f"share {training_dropout['f32_peak_share']} against "
          f"{training_fused['f32_peak_share']}")

    # (g): ResNet-50 training
    resnet = paddle_tpu_torch.ResNet(RESNET_DEPTH,
                                     RESNET_CLASSES).init_params(seed=0)
    training_resnet, resnet_parity = run_resnet(resnet)
    print("phase 3: " + ", ".join(f"{k} {v}"
                                  for k, v in training_resnet.items()))
    keep_phase3(phase3, "g_resnet", training_resnet)
    t_phase = _phase_seconds("phase 3 (d)-(g) and (j)", t_phase)

    # (l): ResNet-50 under bf16 amp from (g)'s initial weights, held
    # against (g)'s float64 step
    resnet_amp = paddle_tpu_torch.ResNet(RESNET_DEPTH, RESNET_CLASSES)
    resnet_amp.load_state_dict(resnet_parity["init"])
    paddle_tpu_torch.amp.enable(resnet_amp)
    training_resnet_amp = run_resnet_amp(resnet_amp, resnet_parity,
                                         training_resnet)
    del resnet_parity
    print("phase 3: " + ", ".join(f"{k} {v}"
                                  for k, v in training_resnet_amp.items()))
    keep_phase3(phase3, "l_resnet_amp", training_resnet_amp)
    print(f"phase 3: resnet50 step, amp bf16 against f32: "
          f"{training_resnet_amp['step_ms_median']} ms against "
          f"{training_resnet['step_ms_median']} ms, "
          f"{training_resnet_amp['images_per_s']} against "
          f"{training_resnet['images_per_s']} images/s, bf16 peak share "
          f"{training_resnet_amp['bf16_peak_share']} (f32 peak share "
          f"{training_resnet['f32_peak_share']} in f32), peak memory "
          f"{training_resnet_amp['peak_memory_gb']} against "
          f"{training_resnet['peak_memory_gb']} GB")
    t_phase = _phase_seconds("phase 3 (l)", t_phase)

    # (h): DeepFM training; and the reference demo's head width 16 served
    deepfm = paddle_tpu_torch.DeepFM(hash_dim=DEEPFM_HASH,
                                     device=DEV).init_params(0)
    training_deepfm = run_deepfm(deepfm)
    print("phase 3: " + ", ".join(f"{k} {v}"
                                  for k, v in training_deepfm.items()))
    keep_phase3(phase3, "h_deepfm", training_deepfm)
    demo = run_demo_head16()
    print("phase 3: " + ", ".join(f"{k} {v}" for k, v in demo.items()))
    keep_phase3(phase3, "demo_head16", demo)
    t_phase = _phase_seconds("phase 3 (h) and the head-width-16 demo",
                             t_phase)

    # (i): BERT-base pretraining on the attention_fuse route (#5, #8, #9);
    # the earlier phases' cached blocks go back first
    torch.cuda.empty_cache()
    bert_fused, bert_flash, bert_composed = _bert_models()
    # (k) starts both kernel routes from these initial weights
    bert_init = {k: v.detach().cpu().clone()
                 for k, v in bert_fused.state_dict().items()}
    training_bert, bert_parity = run_bert(bert_fused, bert_flash,
                                          bert_composed)
    del bert_composed
    for r in training_bert:
        print("phase 3: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    keep_phase3(phase3, "i_bert", training_bert)
    print(f"phase 3: BERT-base step, attention_fuse (bhtd) route against "
          f"use_flash: {training_bert[0]['step_ms_median']} ms against "
          f"{training_bert[1]['step_ms_median']} ms, "
          f"{training_bert[0]['tokens_per_s']} against "
          f"{training_bert[1]['tokens_per_s']} tokens/s, f32 peak share "
          f"{training_bert[0]['f32_peak_share']} against "
          f"{training_bert[1]['f32_peak_share']}")
    t_phase = _phase_seconds("phase 3 (i)", t_phase)

    # (k): BERT-base under bf16 amp on both kernel routes, (i)'s models from
    # their initial weights, held against (i)'s float64 step
    for m in (bert_fused, bert_flash):
        m.load_state_dict(bert_init)
        paddle_tpu_torch.amp.enable(m)
    del bert_init
    torch.cuda.empty_cache()
    training_bert_amp = run_bert_amp(bert_fused, bert_flash, bert_parity)
    del bert_parity
    for r in training_bert_amp:
        print("phase 3: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    keep_phase3(phase3, "k_bert_amp", training_bert_amp)
    for amp_r, f32_r in zip(training_bert_amp, training_bert):
        print(f"phase 3: {amp_r['route']} against f32 ({f32_r['route']}): "
              f"{amp_r['step_ms_median']} ms against "
              f"{f32_r['step_ms_median']} ms, {amp_r['tokens_per_s']} "
              f"against {f32_r['tokens_per_s']} tokens/s, bf16 peak share "
              f"{amp_r['bf16_peak_share']} (f32 peak share "
              f"{f32_r['f32_peak_share']} in f32), peak memory "
              f"{amp_r['peak_memory_gb']} against "
              f"{f32_r['peak_memory_gb']} GB")
    t_phase = _phase_seconds("phase 3 (k)", t_phase)

    # the fused route's steps, then the unfused route's (#14/#15 at 12
    # launches a token) on ring caches at both batches and paged at b=64
    unfused = paddle_tpu_torch.Transformer(**BASE, fused_decode_step=False)
    unfused.load_state_dict(model.state_dict())
    profiled = [(model, b, False, "") for b in BATCHES]
    profiled += [(model, max(BATCHES), True, "")]
    profiled += [(unfused, b, False, "_unfused") for b in BATCHES]
    profiled += [(unfused, max(BATCHES), True, "_unfused")]
    for m, b, paged, tag in profiled:
        prof = profile_serving(m, b, paged=paged, tag=tag)
        label = (f"b={b}{' paged' if paged else ''}"
                 f"{' unfused' if tag else ''}")
        if tag:
            # prefill is the fused route's: only the decode step differs
            prof.pop("prefill")
        for phase, r in prof.items():
            if not r["device_busy_ms"]:
                print(f"phase 4: {label} {phase}: device time not measured "
                      f"(the profiler saw no device events)")
                continue
            print(f"phase 4: {label} {phase} per "
                  f"{'prefill' if phase == 'prefill' else 'step'}: wall "
                  f"{r['wall_ms']} ms, device busy {r['device_busy_ms']} "
                  f"ms, idle share {r['idle_share']}, the megastep "
                  f"{r['megastep_ms']} ms, the FFN {r['ffn_ms']} ms, "
                  f"flash-decode {r['flash_decode_ms']} ms")
            for name, ms in r["top"]:
                print(f"    {ms:.4f} ms  {name}")
    bert_feed = _to(bert_batch(BERT_BATCH, seed=2), DEV)
    profiles = {}
    amp_parent = [("amp_bf16_parent", amp_model, {})] if args.parent else []
    for tag, m, kw in (("flag_off", train_model, {}),
                       ("fused", fused_train, {}),
                       ("fused_dropout", drop_models[0], {}),
                       ("amp_bf16", amp_model, {}), *amp_parent,
                       ("bert_bhtd", bert_fused,
                        dict(feed=bert_feed, lr=BERT_LR)),
                       ("bert_use_flash", bert_flash,
                        dict(feed=bert_feed, lr=BERT_LR)),
                       ("bert_amp_bf16_bhtd", bert_fused,
                        dict(feed=bert_feed, lr=BERT_LR)),
                       ("bert_amp_bf16_use_flash", bert_flash,
                        dict(feed=bert_feed, lr=BERT_LR))):
        if tag.startswith("bert"):  # (i)'s models are (k)'s: amp by tag
            (paddle_tpu_torch.amp.enable if "amp" in tag
             else paddle_tpu_torch.amp.disable)(m)
        if tag.endswith("_parent"):  # the same step on the parent's kernels
            with kernel_library(parent_lib()):
                r = profile_training(m, tag, **kw)
        else:
            r = profile_training(m, tag, **kw)
        profiles[tag] = {k: v for k, v in r.items()
                         if k not in ("top", "elementwise", "by_op")}
        with open(os.path.join(OUT_DIR, f"profile_training_split_{tag}.json"),
                  "w") as f:
            json.dump({k: r[k] for k in ("phases", "dropout_add_ms",
                                         "elementwise_ms", "elementwise",
                                         "by_op")}, f, indent=1)
        if not r["device_busy_ms"]:
            print(f"phase 4: training step {tag}: device time not measured "
                  f"(the profiler saw no device events)")
            continue
        print(f"phase 4: training step {tag}: wall {r['wall_ms']} ms, "
              f"device busy {r['device_busy_ms']} ms, idle share "
              f"{r['idle_share']}, gemm.cuh's kernels {r['gemm_cuh_ms']} "
              f"ms, the backward walks {r['walks_ms']} ms, #1's attention "
              f"{r['qkv_fwd_ms']} ms, the flash forward {r['flash_fwd_ms']} "
              f"ms, the tensor-core kernels {r['tensor_core_ms']} ms, "
              f"cuBLAS GEMMs {r['library_gemm_ms']} ms")
        for name, ms in r["top"]:
            print(f"    {ms:.4f} ms  {name}")
        if tag.startswith("bert_amp"):
            print(f"phase 4: training step {tag}: #5, #8, #9 in bf16 "
                  f"(flash_tc.cuh, flash_bwd_tc.cuh on Bhtd) "
                  f"{r['bhtd_bf16_ms']} ms a step")
        if "amp_bf16" in tag:
            print(f"phase 4: training step {tag}: device ms by phase "
                  f"{r['phases']}; #16/#17 {r['dropout_add_ms']} ms, "
                  f"PyTorch's elementwise and reduction kernels "
                  f"{r['elementwise_ms']} ms; by kernel:")
            for name, ms in r["elementwise"]:
                print(f"    {ms:.4f} ms  {name}")
            print(f"phase 4: training step {tag}: device time by launching "
                  f"op:")
            for name, ms in r["by_op"]:
                print(f"    {ms:.4f} ms  {name}")
    profile_rn = profile_resnet(resnet)
    profile_rn_amp = profile_resnet(resnet_amp, "amp_bf16")
    if profile_rn["dot_stats_ms"]:
        records[("dot_col_stats", max(BATCHES))]["per_step"] = {
            k: profile_rn[k] for k in ("dot_stats_ms", "dot_stats_bound_ms",
                                       "dot_stats_bound_share")}
    if profile_rn_amp["device_busy_ms"]:
        for k, name in (("#18", "channel_stats_bf16"),
                        ("#19", "dot_col_stats_bf16"),
                        ("#20", "ssa_fwd_bf16"), ("#21", "ssa_bwd_bf16")):
            records[(name, max(BATCHES))]["per_step"] = dict(
                ms=profile_rn_amp["conv_bn_ms"][k],
                bound_ms=profile_rn_amp["bf16_bound_ms"][k],
                bound_share=profile_rn_amp["bf16_bound_share"][k])
    for prof_rn in (profile_rn, profile_rn_amp):
        label = f"resnet50 training step {prof_rn['tag']}"
        if not prof_rn["device_busy_ms"]:
            print(f"phase 4: {label}: device time not measured (the "
                  "profiler saw no device events)")
            continue
        print(f"phase 4: {label} (batch {RESNET_BATCH}): wall "
              f"{prof_rn['wall_ms']} ms, device busy "
              f"{prof_rn['device_busy_ms']} ms, idle share "
              f"{prof_rn['idle_share']}; #19 {prof_rn['dot_stats_ms']} ms a "
              f"step against its 36 sites' summed bound "
              f"{prof_rn['dot_stats_bound_ms']} ms (share "
              f"{prof_rn['dot_stats_bound_share']}); cuDNN "
              f"{prof_rn['cudnn_ms']} ms, cuBLAS {prof_rn['cublas_ms']} ms, "
              f"PyTorch's elementwise and "
              f"reduction kernels {prof_rn['elementwise_ms']} ms; conv + BN "
              f"kernels a step {prof_rn['conv_bn_ms']} ms"
              + (f" against their summed bf16 bounds "
                 f"{prof_rn['bf16_bound_ms']} ms (shares "
                 f"{prof_rn['bf16_bound_share']})"
                 if "bf16_bound_ms" in prof_rn else ""))
        for name, ms in prof_rn["top"]:
            print(f"    {ms:.4f} ms  {name}")
        print(f"phase 4: {label} device time by launching op: "
              f"{prof_rn['by_op']}")
        print(f"phase 4: {label} elementwise by kernel: "
              f"{prof_rn['elementwise']}")
        print(f"phase 4: {label} layout-conversion kernels (NCHW/NHWC, "
              f"transpose): {prof_rn['layout_kernels'] or 'none'}")
    profile_fm = profile_deepfm(deepfm)
    if not profile_fm["device_busy_ms"]:
        print("phase 4: deepfm training step: device time not measured "
              "(the profiler saw no device events)")
    else:
        print(f"phase 4: deepfm training step (batch {DEEPFM_BATCH}): wall "
              f"{profile_fm['wall_ms']} ms, device busy "
              f"{profile_fm['device_busy_ms']} ms, idle share "
              f"{profile_fm['idle_share']}, "
              f"{profile_fm['device_kernels']} kernel names; #22 "
              f"{profile_fm['gather_ms']} ms, #23 {profile_fm['apply_ms']} "
              f"ms, sort kernels {profile_fm['sort_ms']} ms a step")
        for name, ms in profile_fm["top"]:
            print(f"    {ms:.4f} ms  {name}")
    t_phase = _phase_seconds("phase 4", t_phase)

    # launches over every counted path; the FFN counter is split between
    # the ring paths (#11) and the paged ones (#13)
    paths = runs + serving + runs_128 + [
        *training_128["amp"], *training_128["f32"], serving_128, training,
        training_fused, training_dropout, training_amp, training_resnet,
        training_resnet_amp, training_deepfm, demo, *training_bert,
        *training_bert_amp]
    total = {name: sum(r["launches"][name] for r in paths)
             for name in paths[0]["launches"]}
    paged_ffn = sum(r["launches"]["ffn"] for r in paths
                    if r["launches"]["megastep_paged"]
                    or r["launches"]["megastep_paged_dh128"])
    total["ffn_paged"] = paged_ffn
    total["ffn"] -= paged_ffn
    kernels_line = []
    for name in ("qkv_attention_fwd", "qkv_bwd_dq", "qkv_bwd_dkv",
                 "megastep", "ffn", "megastep_paged", "ffn_paged",
                 "flash_decode", "flash_decode_paged", "flash_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_bhtd",
                 "flash_bwd_dq_bhtd", "flash_bwd_dkv_bhtd", "dropout_add_fwd",
                 "dropout_add_bwd", "channel_stats", "dot_col_stats",
                 "ssa_fwd", "ssa_bwd", "multi_table_gather",
                 "multi_table_apply",
                 *(name + "_bf16"
                   for name in paddle_tpu_torch.kernels.BF16_KERNELS),
                 *(name + "_dh128"
                   for name in paddle_tpu_torch.kernels.DH128_KERNELS
                   # on no path at 128: in the bthd kernels' records
                   if "_bhtd" not in name)):
        r = dict(records[(name, max(BATCHES))])
        r.pop("library_max_abs_err", None)
        r["launches"] = total[name]
        require(r["launches"] > 0, f"{name}: no launch on the main paths")
        kernels_line.append(r)
    print(json.dumps({"main_path": runs, "serving": serving,
                      "head128": runs_128, "serving_head128": serving_128,
                      "training_head128_amp": training_128["amp"],
                      "training_head128_f32": training_128["f32"],
                      "training": training, "training_fused": training_fused,
                      "training_dropout": training_dropout,
                      "training_amp": training_amp,
                      "training_resnet": training_resnet,
                      "training_resnet_amp": training_resnet_amp,
                      "training_deepfm": training_deepfm, "demo": demo,
                      "training_bert": training_bert,
                      "training_bert_amp": training_bert_amp,
                      "gelu_bf16": gelu,
                      "profile_resnet": {k: v for k, v in profile_rn.items()
                                         if k != "top"},
                      "profile_resnet_amp": {
                          k: v for k, v in profile_rn_amp.items()
                          if k != "top"},
                      "profile_deepfm": profile_fm, "gemm": gemm_records,
                      "flash_bwd": flash_bwd, "walk_builds": builds,
                      "tile_builds": tiles, "sass_mma": mma,
                      "parent": args.parent,
                      "parent_registers": registers,
                      "parent_bits": parent_bits,
                      "profile_training": profiles,
                      "power": smi}))
    print_phase3(phase3)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
