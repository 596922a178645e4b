#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hqtransformer_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

With `--k1-only` it runs phase 1, decode attention's checks and timings
of phases 2 and 7 and the K1 sweep, and stops without the result line
(to compare two commits' K1, run it in a checkout of each, in turns).
With `--gn-only` it runs phases 1 and 18 and prints phase 18's kernel
entry as its JSON line. With `--graphs-only` it runs phases 1 and 19.

1. Device: prints the card, `nvidia-smi`'s name and power limit, the torch
   and CUDA versions; builds every CUDA kernel from
   hqtransformer_tpu_torch/csrc (one nvcc each, all at once) and prints the
   build time and ptxas report (registers, spills, shared memory, and any
   wgmma or setmaxnreg warning), and for each decode attention kernel its
   int-to-float conversions (I2F) and byte permutes in the SASS
   (`cuobjdump`).
2. Kernels against their plain PyTorch versions at the flagship shapes
   (TF32 off for matmuls and convolutions):
   - decode attention, L=12 T=64 B=128 D=1536 24 heads, f32 and bf16,
     pos in {0, 1, 7, 8, 15, 16, 31, 32, 33, 63} (the edges of the rows a
     warp takes at once and of the kernel's shared-memory rounds), and
     L=2 T=160 B=8 at pos in {64, 65, 129, 159} (several rounds): caches
     bit-equal, y allclose at 1e-5 (f32) / 2e-2 (bf16);
   - top-k sampling, bf16 and f32, T=0.95, shared uniforms, on four kinds
     of rows (random; integers with ties at every rank; 90% signed zeros;
     random x30, whose k-th value lies below max - 44) at V=8192 (640
     rows) and V=1000 (256 rows), k in {1, 2, 2048, V-1, V}: the kernel's
     threshold output equals topk_threshold bit for bit, its kept set is
     the exact top-k within [max - 44, max], every code lies in it, k=1
     draws an argmax, codes equal the plain version's except rows whose
     draw lies within 1e-5 of the row's mass from the CDF boundary between
     the two codes, at most 1% of rows.
   Then times each kernel, its plain version and one PyTorch library call
   computing the same function, with CUDA events, and computes the least
   time the card could take (the bound). K1 is also swept over every
   position the sampler launches it at (1..63), on int8 and on bf16 caches
   of the same values at batch 128, each time beside its bound, with the
   fitted fixed and per-row costs and the sum over a batch's 756 launches
   beside the summed bound. K2 at both main-path shapes
   ([512, 8192] and [128, 8192] bf16, k 2048), its library call topk +
   softmax + cumsum + searchsorted on the same uniforms.
   K2 with `bisect3` (the TPU kernel's quartile search) at the 3-level
   draw shapes [128 | 512 | 2048, 8192], k in {1, 2048}, T 1.0, on random
   and tied bf16 rows and random f32 rows: its threshold output equals
   `replay_threshold(bisect3=True)` and `topk_threshold3` bit for bit,
   with the kept-set and code checks above; then timed at those shapes
   with `bisect3` off and on, in turns, beside its plain version, the
   library call and the bound.
3. The main path at full width: the flagship class-conditional ImageNet-256
   config (12 spatial layers, d=1536) with seeded random weights in bf16,
   TwoStageModel.make_pixel_sampler(top-k 2048, T 0.95) on 128 labels,
   twice (the first call warms up): codes in range, pixels
   [128, 256, 256, 3] finite in [0, 1], and exactly 756 decode-attention
   launches (at pos 1..63) and 128 sampling launches per call. Prints
   samples/s and peak memory, then a breakdown: the AR loop and the stage-1
   decode timed apart, with the device's busy time and largest kernels from
   torch.profiler.
4. Nearest-code search (K3) against its plain version (TF32 off): N=8191,
   D in {256, 1024, 4096}, K in {8192, 1000}, f32 (6 pairs of bf16
   pieces) and bf16 (1 pair), both mixed pairs at D=256 (3 pairs), and
   bf16 at D in {40, 200} (a ragged tail of D) and at N=37 D=64 K=1000 and
   N=100 D=32 K=100 (less than one tile): codes equal but for rows whose
   two codes' distances, recomputed in f64, lie within 1e-5 (|z|^2 +
   |e|^2) of each other, at most 0.1% of rows; and integer-valued inputs
   with every code four times in the codebook, where both versions must
   take the lowest index of each exact tie, in f32 and bf16. Each case
   names the pair list it ran. Then, in bf16 and in f32 at every shape the
   encode paths launch it at (the flagship top and bottom levels, which
   the 3-level middle and bottom share at batch 32, the 3-level top at
   batch 32, and the avgpool / conv2 top, N 8192 D 256, where no row may
   differ), compares it with its plain version by the same rule and
   times the kernel, its plain version and cuBLAS addmm + argmin in f32
   (extra peak memory of each beside); the bound is the function's
   2 N K D operations (one pass) at the bf16 tensor-core rate, in either
   dtype, and a line of its own gives the design's floor, its passes at
   that rate (six in f32). One more line in bf16, outside the JSON: the
   bf16 cuBLAS product z @ e.T alone at each shape (not the same function:
   how close the wgmma main loop comes to cuBLAS's bf16 GEMM).
5. The encode slice at full width: `make_reconstructor` on the flagship
   stage-1 HQ-VAE (seeded random bf16 weights) on 128 seeded images, twice:
   pixels [128, 256, 256, 3] finite in [-1, 1], codes in range, exactly 2
   K3 and no K1 or K2 launches per call. Prints images/s, peak memory and a
   breakdown (encoder, quantize with its K3 launches, decoder) from
   torch.profiler. Then `TwoStageModel.extract_codes` and `forward` on the
   flagship two-stage model at batch 128 (logits [128, 64, 8192] and
   [128, 256, 8192], finite, 2 K3 launches per call), and
   `make_reconstructor` on the 3-level HQ-VAE at batch 32 (3 K3 launches),
   and `make_reconstructor` on the flagship stage-1 at its default f32 (the
   eval_stage1.py path, seeded random f32 weights) at batch 128, twice
   (2 K3 launches on the f32 x f32 route).
6. A reference on a small input: the tiny config, f32, greedy (top-k 1),
   sampled through the CUDA kernels and through the CPU plain versions with
   the same weights: equal codes, pixels within 1e-3; and the same images
   encoded on both: `extract_codes` equal, reconstructions within 1e-3;
   and the flagship level-3 config cut to a tiny size (d 128), greedy at
   every level, with and without `bisect3`: the three levels' codes equal,
   pixels within 1e-3; and that tiny config with the fully causal
   'top2mid2bot' depth: its teacher-forced logits on the card within 1e-4
   of the CPU's, f32; and the tiny 2-level config with text conditioning
   (an 8-token caption) and unconditional with the `reduce` embedding: the
   teacher-forced logits (the text logits too) within 1e-4 of the CPU's,
   f32.
7. int8max serving (run right after phase 3, on its model and weights):
   - decode attention's int8 kernel against its plain version with int8
     caches and new rows over all of -128..127 and an f32 or bf16 q, at
     phase 2's positions, the int8 kernel's stage edges (pos 15..17,
     31..33, 47..49, 63 at T=64 B=128), partly filled row steps (pos 9,
     14, 40), round edges (63..65, 127..129 and stage edges at T=160 B=8),
     batch 1024 at pos 33 and 63, and head dim 32 (48 heads): caches
     bit-equal, y (in the int8 values' units, dequantized by a V scale of
     1/127) allclose at 1e-5 (f32 q) / 2e-2 (bf16 q); a q with a NaN and
     an infinity gives NaN in y exactly where the plain version does;
     then timed at pos 33, B 128, beside the
     bf16 kernel (no single PyTorch call attends over an int8 cache: its
     library time is null; bf16 SDPA over the dequantized cache is printed
     for context), and at pos 33, B 1024;
   - the A8W8 products on the card against the CPU on the same int8
     inputs (`_int_mm` at the flagship's fused-QKV and MLP gemm shapes,
     the int8 convolution at the decoder's largest, 128 channels at 256^2
     on 2 images): int32 results equal;
   - calibration at the flagship: KV scales from one bf16 sampling run at
     batch 128 (`calibrate_kv_scales`), stage-2 activation scales from the
     teacher-forced forward on that run's codes (the same generator seed)
     and decode scales from `decode_code` on them; saved to
     build/int8max_scales.pkl and loaded back bit for bit;
   - `make_pipelined_sampler` in int8max (all four switches) and in bf16
     on the same labels, batch 128: one fill call and two steady calls,
     each with codes in [0, 8192), pixels [128, 256, 256, 3] finite in
     [0, 1], 756 decode-attention launches (all on the int8 variant in
     int8max) and 128 sampling launches, and int8 gemms and convolutions
     counted (int8max) or none (bf16); samples/s and peak memory; then the
     int8max AR loop and int8 decode broken down under torch.profiler; one
     steady call of each mode at batch 1024 (samples/s, peak memory); one
     steady call at batch 128 in int8max without the spatial gemms
     (bench.py's BENCH_INT8_SPATIAL=0), with the same checks;
   - the bf16 run's codes through `make_hierarchical_scorer` in bf16 and
     in int8max: top-1 agreement of the per-step logits and their mean KL
     (numbers to record; the weights are random).

8. The 3-level family at full width (after phase 7's model is freed): the
   flagship level-3 config (12 spatial layers, d 1536, three 8192-code
   levels, parallel-add) with seeded random bf16 weights,
   `make_pixel_sampler_multilevel(top-k 2048, T 1.0 a level)` on 128
   labels, twice, then once with `bisect3`: codes in range, pixels
   [128, 256, 256, 3] finite in [0, 1], exactly 756 K1 and 192 K2
   launches a call (all 192 with `bisect3` in the third); samples/s and
   peak memory; then the AR loop and the stage-1 decode broken down as in
   phase 3.
9. int8max serving of the 3-level family, on phase 8's model and weights,
   as the JAX package's measure_throughput.py runs it: KV scales from one
   bf16 sampling call at batch 128, decode scales from `decode_code` on
   its three maps, stage-2 scales from the teacher-forced forward on its
   first 32 samples; saved to build/int8max_level3_scales.pkl and loaded
   back bit for bit. Two int8max calls of `make_pixel_sampler_multilevel`
   (top-k 2048, T 1.0) at batch 128: codes in range, pixels
   [128, 256, 256, 3] finite in [0, 1], exactly 756 K1 launches, all on
   the int8 variant, 192 K2, int8 gemms and convolutions counted;
   samples/s and peak memory; the first call's codes' per-level agreement
   with phase 8's first bf16 call (one generator seed; random weights); the
   int8max AR loop and int8 decode broken down; one call at batch 256 (the
   JAX bench family's l12-level3-int8max batch). Then the 4x4-top level-3
   config (`hqtransformer-l12-top4x4-level3.yaml`, 16 spatial steps) with
   seeded random bf16 weights: two bf16 calls at batch 128 and, after the
   same calibration, one int8max call, with the same checks (180 K1 and
   48 K2 launches a call).
10. The other conditionings at full width, with seeded random bf16
   weights (after phase 9's models are freed):
   - K1 against its plain version (caches bit-equal, y within 2e-2, in
     units of 1/127 on int8 caches) on the text path's cache, T 127 (a
     64-token caption and 64 image positions), B 128, d 1536, at pos 63,
     64, 65, 95 and 126, bf16 and int8 caches; at FFHQ's d 1024 with
     16 heads, T 64, B 128, at pos 0, 33 and 63; and in bf16 at B 1024,
     the large calls' batch: T 127 d 1536 at pos 64 and 95, a 12-layer
     T 127 cache (2.4e9 elements) at layer 11 (past 2^31 elements) and
     pos 64 and 126, and d 1024 T 64 at pos 33 and 63. Then K1 timed at every
     text position 64..126 on both caches (pos 95 and 126 printed beside
     their bounds; the sum over a text batch's 756 launches beside the
     summed bound, with the fitted fixed and per-row costs) and at pos 33
     on FFHQ's cache;
   - FFHQ l24 (`configs/ffhq/stage2/hqtransformer-l24-ffhq.yaml`:
     unconditional, `reduce`, 24 layers, d 1024) through
     make_pixel_sampler(top-k 2048, T 0.95) on 128 dummy labels, twice:
     codes in range, pixels [128, 256, 256, 3] finite in [0, 1], exactly
     1,512 K1 launches (pos 1..63) and 128 K2; samples/s, peak memory, the
     AR loop and stage-1 decode broken down; one call at batch 1024;
   - CC15M l12 (`configs/cc15m/stage2/hqtransformer-l12-cc15m.yaml`):
     128 captions written here, tokenized by the port's BPE-16k tokenizer
     into [128, 64] ids; two bf16 calls with the same checks and 756 K1
     launches, all at pos 64..126, a breakdown, one call at batch 1024;
     then int8max calibrated as measure_throughput.py does (KV scales, a
     bf16 pixel-sampler call's codes for the decode scales, its first 64
     samples for the stage-2 scales), saved to
     build/int8max_txt_scales.pkl and loaded back bit for bit, and one
     int8max call at batch 128 (756 K1 launches, all int8) on the first
     bf16 call's generator seed, with the per-level code agreement.
11. The other samplers at full width, seeded random bf16 weights, batch
   128 (after phase 10's models are freed):
   - K1 against its plain version on Transformer1d's cache (T 319: a
     64-token prefix and 256 codes; d 1536, 24 heads) at pos 64, 191 and
     318 (five 64-row rounds), batch 128 and 1024: caches bit-equal, y
     within 2e-2; then K1 timed beside its plain version, SDPA and its
     bound at T 319 (pos 64, 191, 318), at phase 10's T 127 (pos 95, 126)
     and at d 1024 (pos 33); K2 at the bidirectional joint draw, bf16
     [640, 8192], k 2048, T 0.95, against its plain version (kept set,
     codes) and timed beside its plain version, the library call and its
     bound;
   - `hqtransformer-l12-top8x8-bidirectional.yaml` and `-causal.yaml`
     (top2bot) through make_pixel_sampler (top-k 2048, T 0.95) twice
     each: 756 K1 and 64 K2 (bidirectional) or 320 K2 (top2bot) a call,
     with each AR loop profiled;
   - the flagship with use_given_top (seeded random top codes: codes_t
     equal to them, 128 K2) and with top-k 2048 then top-p 0.95 at both
     levels (756 K1 and no K2 launch; every draw inside the plain
     filter's kept set, checked on the card), twice each, the top-p AR
     loop profiled;
   - `vqvae2-l12-top8x8.yaml` (IGPT) through make_pixel_sampler_igpt
     (top-k 256, T 1.0), twice (756 K1, 64 K2); then
     `vqvae2-l4-cond-top8x8-pred-bot16x16.yaml` (Transformer1d) through
     make_txt2img_sampler (top-k 256, T 1.0) with the IGPT call's top
     codes as its 64-token prefix, twice (1,020 K1 at pos 64..318, 256
     K2), its bottom codes decoded with the top codes by stage 1; both AR
     loops profiled.
   Every call goes through `checked_call` (samples/s, peak memory).
   Every sampler call of every phase, there and elsewhere, also requires
   the GroupNorm kernel at each GroupNorm of the stage-1 decoder in each
   decode chunk (`gn.launches`: 33 a flagship chunk of 128, 27 a 3-level
   one) and no layout copy (`gn.layout_copies`).
   At the end, the tiny f32 bidirectional, top2bot, IGPT and
   Transformer1d models sample greedily on the card and on the CPU:
   equal codes.

12. The rest of stage 1 (after phase 5's f32 reconstruction), seeded
   random weights, batch 128:
   - `make_reconstructor` on `hqvae-avgpool-top8x8.yaml` (average pooling
     down, nearest up) and `hqvae-conv2-pixelrecon-top8x8.yaml` (a stride-2
     conv down, a conv-transpose up; the three conv2 configs share the
     generator), twice in bf16 and once in f32: 2 K3 and no K1, K2 launches
     a call, codes in [0, 8192), pixels finite in [-1, 1]; images/s, peak
     memory and the bf16 call broken down as in phase 5; then the conv2
     generator's forward with `bottom_bypass` (its `bottom_start` is 0);
   - `TwoStageModel.extract_codes(temp_soft_labels=1.0)` on
     `hqtransformer-l12-top8x8-soft.yaml`, bf16 weights, twice: no K3
     launch, soft maps [128, 64 | 256, 8192] whose rows sum to 1 within
     1e-4, hard codes the argmin of the f32 distances (recomputed); their
     agreement with the K3 codes of a plain `extract_codes`; one stochastic
     call with a CUDA generator (codes in range); wall ms, peak memory.
   At the end, tiny f32 VQGAN (learned codebook), VQGAN2 (deconv2d with
   concat, nearest with sum), 2-level HQ-VAEs (nearest, conv2) and a
   3-level conv2 HQ-VAE reconstruct on the card and on the CPU from the same
   weights and images: codes equal (or, at rows tied within f32 rounding,
   as phase 4 allows), pixels within 1e-3. The JSON line gains
   `vq_argmin_d256`, K3 at the avgpool / conv2 top in bf16.

13. int8 serving of every sampler and the serving entry points (after
   phase 12), seeded random bf16 weights, batch 128:
   - K1's int8 kernel against its plain version on Transformer1d's cache
     (L 4, T 319, d 1536, 24 heads) at pos 64, 191, 255 and 318, batch
     128 and 1024: caches bit-equal, y within phase 7's bound; then timed
     at each position beside its plain version and its bound (the int8
     bytes read once). The JSON line gains `decode_attention_int8_t320`
     (pos 191; its launches are Transformer1d's int8 call's);
   - `-bidirectional` and `-causal` (top2bot): two bf16 calls, the three
     calibrations (measure_throughput's), two int8max calls of
     make_pixel_sampler (756 K1, all int8; 64 or 320 K2; exactly the
     3,072 spatial A8W8 gemms, the depth passes and head_bot float),
     samples/s and peak memory beside bf16's, the code agreement on one
     seed, the int8max AR loop profiled;
   - IGPT with an int8 cache and the int8 decode (756 int8 K1, 64 K2,
     int8 convolutions and no int8 gemm) and Transformer1d with an int8
     cache (1,020 int8 K1 at pos 64..318, 256 K2), scales from a float
     run (`_flat_kv_scales`), each twice beside two bf16 calls, AR loops
     profiled;
   - the CLIs, each in a subprocess, with their wall seconds:
     `cli.sampling_hqmodel` from an fp16 Lightning `.ckpt` of the
     flagship's random weights (two pickles [128, 3, 256, 256] f32 in
     [0, 1]); `cli.measure_throughput` in int8max, `scales_out=` and then
     `scales_in=` at batch 128 (its ms/sample lines);
     `cli.sampling_hqmodel_txt2img` on CC15M with four captions and
     `--clip-rerank 4` by a random ViT-B/32 state dict (the ranked pickle,
     finite sorted scores).
   At the end, tiny f32 bidirectional, top2bot, IGPT and Transformer1d
   models with an int8 KV cache sample greedily on the card and on the
   CPU: equal codes; and tiny bidirectional and top2bot models in
   int8max, teacher-forced on seeded codes: top-1 agreement of the card's
   and the CPU's depth logits at least 90%.

14. The data pipeline, FID-Inception and the evaluation CLIs (after
   phase 13): 256 PNGs written by the script's own encoder (zlib and
   struct; sizes 256x256, 320x240, 500x375, 375x500, 200x300; RGB, L, P,
   RGBA, LA; every row filter on some rows) under build/smoke_eval/val/
   in 4 classes; the loader alone (the decoder it took, ms an image of
   decode and of the valid transform, images/s at batch 128 with 8
   workers; two train passes with one seed equal); `cli.eval_stage1`
   --fid --code-usage --top-only --batch-size 128 on the flagship stage 1
   (a trainer's .ckpt of seeded random f32 weights) with seeded He-scaled
   pt_inception-layout weights, in this process (exactly 8 K3 launches,
   no K1 or K2; MSE finite, both levels' usage in (0, 1], rFID finite)
   and as a subprocess, wall seconds and images/s; FID-Inception alone
   (f32, batch 128, 256^2): images/s, peak memory and its bound, its
   features of 4 images within 1e-4 of a CPU run; `cli.compute_fid_stats`
   --save-acts over the tree, then `cli.eval_hqmodel` on phase 13's
   samples (FID finite, precision, recall, coverage in [0, 1], acts.npz),
   a second call served from the cache with no Inception forward, pixel
   features' FID; `frechet_distance` at 2048 dimensions timed on the
   host. The JSON line gains `vq_argmin_f32_eval`, f32 K3 with the
   launches of the eval_stage1 run.

15. Stage-2 training (after phase 14): the flagship
   (`hqtransformer-l12-top8x8.yaml`, 12 layers, d 1536) and its stage 1
   on seeded random weights, batch 64, f32 and bf16: 2 warm-up and 10
   timed steps on seeded images (ms a step, images/s, peak memory),
   exactly 2 K3 launches a step and no K1 or K2, 22 GroupNorm kernel
   pairs a step (the frozen encoder's) and no layout copy, finite losses and
   gradient norm; the f32 step broken down (stage-1 codes, forward and
   backward, optimizer) under the profiler; one repeated batch at a
   constant lr 1e-4: the loss falls over 10 steps; `remat` gradients
   within 1e-6 of the plain run (batch 16); one step each of `-level3`
   at batch 32 (3 K3 launches) and `-soft` at batch 16 (none); the tiny
   config's 3 f32 steps on the card and the CPU (parameters within 1e-5);
   the train loader alone on a PNG tree the script writes
   (build/smoke_train/data/, 128 train and 32 val images); then
   `cli.main_stage2` on the flagship in a subprocess, --max-steps 4 from
   phase 14's trainer-layout stage-1 .ckpt, then --resume to 6 (the step
   count continues), and its ckpt_full bundle loads strictly. K3 at the
   training shapes (f32, and bf16 z on an f32 codebook) against plain,
   timed.
16. Stage-1 training (after phase 15): the flagship stage 1
   (`hqvae-pixelshuffle-top8x8.yaml`) at batch 16, f32, the GAN active
   from step 0, LPIPS on seeded He-scaled random VGG16 weights: the
   faithful step (2 warm-up, 5 timed: images/s, peak memory, exactly 4
   K3 launches a step, 55 GroupNorm kernel pairs a step (its no-grad
   generator forward; the rest is autograd) and no layout copy, every
   EMA buffer changed, d_weight finite and positive; one step profiled),
   the fast step likewise (2 K3 and no GroupNorm kernel a step), one
   bf16 step; the tiny stage 1's 2 f32 steps on the card and the CPU
   (the tests' bounds); `cli.main_stage1` in a subprocess, --max-steps 2
   with --lpips-vgg (a torchvision-layout file of the random weights),
   then --resume to 3. K3 at the stage-1 training shapes, timed. The JSON
   line gains `vq_argmin_stage2_train` and `vq_argmin_stage1_train` (f32
   K3 with the timed f32 runs' launches, `dtype` and
   `launches_per_step`).
17. Tensor parallelism (after phase 16; `parallel/tp.py`): K1 against its
   plain version at the flagship's per-rank widths, d 768 with 12 heads
   (tp 2) and d 384 with 6 heads (tp 4), f32 and bf16, batch 128 and
   1024, pos 1, 33, 63, and timed at pos 33 beside its plain version,
   SDPA and its bound; K1's int8 kernel likewise at both widths (f32 and
   bf16 q, batch 64, 128 and 1024, pos 1, 33, 63; caches bit-equal, y
   within phase 7's tolerance), timed at pos 33, batch 128 beside its
   plain version and its bytes bound; the tp-1 flagship sampler (bf16,
   top-k 2048, T 0.95, batch 128, seed 17) in this process, the same
   call again with every draw's bf16 logits moved one bf16 step at
   random (the witness of how far a rounding moves the draws); the
   int8max scales calibrated (`calibrate_int8max`, the artifact the
   ranks serve), the tp-1 int8max sampler, that witness, and the one its
   codes are held to: the same call with every float row-parallel
   layer's bf16 output moved one step at random (under int8max tp adds
   roundings only there, and the int8 quantizers after them carry them
   further than a logit's rounding); the
   calibration on one batch (a short sampling run whose draws are
   recorded, the activation scales on 32 samples' codes); the tp-1
   stage-2 sampler in f32, with a float and with an int8 KV cache. Then
   four processes of this script (`--tp-worker`) on cuda:0, joined by
   gloo (NCCL refuses two ranks on one card): each checks the
   collectives on CUDA tensors (all_reduce over the tp and dp groups in
   f32 and bf16, the exact int32 sum, the max, the gather, the
   barrier), runs the flagship's stage-2 sampler at tp 4 for its first
   16 positions in bf16 and in int8max (180 K1 launches at d 384, on the
   int8 kernel in int8max, and 32 K2 a rank: four ranks' collectives
   cross the host, so the call is cut in length), the flagship pixel
   sampler at tp 2 x dp 2 on the whole batch in bf16 and in int8max
   (exactly 756 K1 launches at d 768, all int8 in int8max, and 128 K2
   launches a rank; the tp ranks of a dp group draw the same codes), its
   stage-2 sampler at tp 2 x dp 2 in f32 (756 K1, 128 K2) and in f32
   with the int8 KV cache for 16 positions, the calibration on tp 1's
   draws and codes, then 3 f32 flagship training steps at tp 2 x dp 2 on
   a global batch of 8 (4 a dp rank; exactly 2 K3 launches a step a
   rank) and saves the whole state (rank 0 writes); the tp-2 ranks also
   score tp 1's codes in bf16 and in int8max. Here: the codes'
   first-position agreement with tp 1's, held in f32 (float and int8
   cache) to >= 0.97 a level and in bf16 and int8max to their
   witnesses' less three standard deviations (top-k 2048 over near-flat
   random-weight logits moves a draw on a rounding, and every later step
   with it), the scorers' logits against tp 1's on the same codes
   (within 4 bf16 steps of the largest logit, argmax equal in >= 90% of
   rows, the bf16 tests' bounds), the tp-2 calibration against tp 1's
   (every rank the same; each scale within 4 bf16 steps, the bf16
   row-parallel sums before it rounding otherwise), the losses (rtol
   1e-4) and parameters against tp 1's 3 steps on the whole batch
   (median 1e-6, 99% within 1e-5), the checkpoint restored at tp 1 and
   one more step. Wall times are gloo on one card, not TP speed. The
   JSON line gains `decode_attention_tp2`, `decode_attention_tp4`,
   `decode_attention_int8_tp2` and `decode_attention_int8_tp4` (launches
   a rank of the tp 2 and tp 4 sampler calls).

18. The GroupNorm-swish kernel (`csrc/group_norm.cu`, no TPU
   counterpart), after phase 17: a flagship decode chunk (bf16, batch
   128, seeded random codes and bf16 serving weights), a 3-level decode
   chunk (batch 128) and stage-2 training's frozen encode (bf16 on f32
   weights, batch 64), each run once with a hook on every GroupNorm:
   exactly 33, 27 and 22 kernel pairs (`gn.launches`), no layout copy
   (`gn.layout_copies`), every input and output channels-last, the
   pixels NHWC-contiguous. The statistics on f32 maps at every served
   shape (and one 40 off 0) against float64: the normalised values within
   twice F.group_norm's error plus 1e-6. Then the kernel against its plain
   version at every (batch, C, H, W, dtype, weight dtype, swish) those
   runs recorded, on seeded maps whose channels have means in [-3, 3] and
   spreads in [0.5, 2], and at f32 maps, bf16 weights, maps 8 and 40 off
   0, C 64 and 32 and a short last tile, and an NCHW input (one layout
   copy counted): in bf16 within a bf16 step of the pre-swish value
   carried through swish plus 1e-5, with at most 1% of the elements
   differing at all, in f32 within 1e-5 of max(1, |value|) (the
   statistics' sums in another order; `GN_STEP`); the kernel repeats
   itself bit for bit. Then timed at every served shape (bf16, swish) beside its plain version, F.silu(F.group_norm) and
   the bytes bound (the map read once and written once at 3.35 TB/s),
   summed over each path's sites, and the flagship decode chunk profiled.
   The JSON line gains `group_norm` (its times at [128, 128, 256, 256],
   the decoder's `norm_out`; launches a flagship decode chunk).

19. The 2-level sampler's depth call replayed from CUDA graphs
   (`sampling/engine.py::_DepthGraphs`), after phase 18: the tiny config
   (bf16, batch 8) in the `parallel` depth mode with top-k 16, with top-p
   0.9 and with bisect3, and in the `bidirectional` and `top2bot` modes;
   the flagship (bf16 serving weights, batch 64, top-k 2048, T 0.95) and
   CC15M text-to-image (batch 32, caption ids); each model under two
   seeded weights dicts, three calls each. Every call runs once eagerly
   (inside `tracing.recording()`, where the depth is never replayed) and
   once from graphs with the generator seeded alike: codes and pixels
   equal, the generator left at the same offset, K2 launches counted as
   the eager call counts them (none with top-p, whose draws leave K2). A
   key's first call captures its graph at its second position, so the
   first call of each weights dict checks the eager step, the capture and
   the replays together.

Prints one JSON line of per-kernel numbers, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failure raises, so the script exits
non-zero without that line; so it does without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / 'configs/imagenet/stage2/hqtransformer-l12-top8x8.yaml'
TINY = ROOT / 'configs/tiny/stage2-tiny.yaml'
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12       # H100 SXM f32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense

# K1 at the flagship main path: 12 layers, 64 cache rows, batch 128,
# d=1536, 24 heads; 12 launches per spatial step x 63 steps.
L, T, B, D, NH = 12, 64, 128, 1536, 24
# K2: one top draw [B, V] and one bottom-group draw [4B, V] per position.
V = 8192
TIMED_POS = 33
# K3: one launch per code level; N = batch x level area, K = 8192 codes.
# The 3-level middle and bottom levels at batch 32 have the flagship top's
# and bottom's (N, D), and the avgpool / conv2 bottom the flagship
# bottom's, so these four shapes are every K3 launch of the encode paths.
LEVEL3 = ROOT / 'configs/imagenet/stage1/hqvae-pixelshuffle-top8x8-level3.yaml'
N_CODES = 8192
K3_SHAPES = (('flagship top = 3-level middle', 8192, 1024),
             ('flagship bottom = 3-level bottom', 32768, 256),
             ('3-level top, batch 32', 2048, 4096),
             ('avgpool/conv2 top, batch 128', 8192, 256))
# The avgpool and conv2 stage-1 configs keep the top level at the bottom's
# dim: their top search is this K3_SHAPES entry.
K3_D256 = 3
B_LEVEL3 = 32
NEAR_TIE = 1e-5
# Names of the port's kernels as the profiler reports them.
PORT_KERNELS = ('decode_attention_kernel', 'decode_attention_int8_kernel',
                'sample_topk_kernel', 'vq_')
# int8max: the batch at which the cache's size matters, and the artifact.
B_LARGE = 1024
SCALES_PATH = ROOT / 'build' / 'int8max_scales.pkl'
LEVEL3_SCALES_PATH = ROOT / 'build' / 'int8max_level3_scales.pkl'
TOP4X4_SCALES_PATH = ROOT / 'build' / 'int8max_top4x4_scales.pkl'
# phase 13's cli.sampling_hqmodel output, which phase 14 evaluates
SMOKE_SAMPLES = ROOT / 'build' / 'smoke_samples'


def require(ok, message) -> None:
    """A check of the run (unlike `assert`, kept under python -O)."""
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {message}')


def nvidia_smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def print_ptxas_report(source: str, text: str) -> None:
    """One line per compiled kernel of `source` from nvcc's -Xptxas=-v
    output: registers, barriers, shared memory and spills; then any
    warning (a wgmma serialised, a setmaxnreg ignored)."""
    kernels = re.findall(r"Compiling entry function '([^']+)'", text)
    spills = re.findall(r'(\d+) bytes spill stores', text)
    used = re.findall(r'Used (.*)', text)
    demangled = subprocess.run(['c++filt'], input='\n'.join(kernels),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    print(f'  {source}: {len(kernels)} kernels')
    for name, n_spill, line in zip(demangled, spills, used):
        name = name.replace('(anonymous namespace)::', '').split('(')[0]
        print(f'    {name.removeprefix("void ")}: {line.strip()}, '
              f'{n_spill} bytes spilled')
    for line in text.splitlines():
        if 'warning' in line.lower():
            print(f'    {line.strip()}')


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn(i) over `iters` back-to-back calls, by CUDA
    events. The stream first sleeps on the card while the host queues every
    call, so that the host's launch overhead leaves no gaps between the
    timed calls. A call that waits for the device (a copy to the host)
    cannot be queued ahead; its time then includes those waits, and the
    script says so."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    cycles = int((time.perf_counter() - t0) * 4e9) + 1_000_000
    for _ in range(2):
        held, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        held.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if queued_ms < held.elapsed_time(start):
            break
        cycles *= 4
    else:
        print(f'  note: the host took {queued_ms:.2f} ms to queue {iters} '
              f'calls, longer than the device sleep; this time includes '
              f'launch gaps')
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """The least time in ms: bytes over the memory rate or operations over
    the card's peak for the operands' type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# ------------------------------------------------------- K1 decode attention

def k1_bytes(pos: int, batch: int, int8: bool, d: int = D) -> int:
    """Bytes K1 must move at `pos` with a bf16 q of width d: q, k_new, v_new
    and the 2 * pos cache rows read once; the two new rows and y written
    once. The caches and the new rows are int8 or bf16."""
    c = 1 if int8 else 2
    return batch * d * (2 + 2 * c + 2 * pos * c + 2 * c + 2)


def k1_flops(pos: int, batch: int, d: int = D) -> int:
    """q.k and a.v over the pos + 1 rows."""
    return 2 * 2 * (pos + 1) * batch * d


# K1 check cases: (L, T, B, positions). The flagship cache at the edges of
# the rows a warp takes at once (4 at hd 64 in bf16, 2 in f32) and of the
# shared-memory rounds (64 rows at hd 64 in bf16, 32 in f32); then a longer
# cache that takes several rounds in both dtypes.
K1_CASES = ((L, T, B, (0, 1, 7, 8, 15, 16, 31, 32, 33, 63)),
            (2, 160, 8, (64, 65, 129, 159)))


def check_decode_attention(da):
    max_err = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for n_layers, n_rows, batch, positions in K1_CASES:
            for pos in positions:
                g = torch.Generator(device='cuda').manual_seed(pos)

                def randn(*shape):
                    return torch.randn(shape, generator=g,
                                       device='cuda').to(dtype)

                kc = randn(n_layers, n_rows, batch, D)
                vc = randn(n_layers, n_rows, batch, D)
                q, kn, vn = randn(batch, D), randn(batch, D), randn(batch, D)
                layer = pos % n_layers
                kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc, vc
                y1 = da.decode_attention_step(q, kn, vn, kc1, vc1, layer,
                                              pos, NH)
                y2 = da.decode_attention_step_plain(q, kn, vn, kc2, vc2,
                                                    layer, pos, NH)
                torch.cuda.synchronize()
                require(torch.equal(kc1, kc2) and torch.equal(vc1, vc2),
                        f'K1 cache rows differ ({dtype}, T {n_rows}, '
                        f'pos {pos})')
                err = (y1.float() - y2.float()).abs().max().item()
                torch.testing.assert_close(y1.float(), y2.float(), atol=tol,
                                           rtol=tol)
                max_err[dtype] = max(max_err.get(dtype, 0.0), err)
                print(f'K1 {str(dtype):14s} T={n_rows:3d} B={batch:3d} '
                      f'pos={pos:3d}: caches bit-equal, max|y - plain| = '
                      f'{err:.3e} (tol {tol})')
    return max_err[torch.bfloat16]


def time_decode_attention(da):
    """bf16 at pos 33, batch 128; the layer rotates over all 12 so that
    each call reads its cache prefix from HBM, not from L2, as on the main
    path."""
    g = torch.Generator(device='cuda').manual_seed(1)
    dt = torch.bfloat16
    kc = torch.randn((L, T, B, D), generator=g, device='cuda').to(dt)
    vc = torch.randn((L, T, B, D), generator=g, device='cuda').to(dt)
    q, kn, vn = (torch.randn((B, D), generator=g, device='cuda').to(dt)
                 for _ in range(3))
    pos = TIMED_POS
    hd = D // NH
    # few enough calls that every launch fits in the device's queue
    kernel = time_ms(lambda i: da.decode_attention_step(
        q, kn, vn, kc, vc, i % L, pos, NH), 240)
    plain = time_ms(lambda i: da.decode_attention_step_plain(
        q, kn, vn, kc, vc, i % L, pos, NH), 24)
    # library yardstick: SDPA over the valid cache rows, pre-permuted to
    # [B, nh, pos+1, hd] outside the timed region
    ks = [kc[l, :pos + 1].reshape(pos + 1, B, NH, hd).permute(1, 2, 0, 3)
          .contiguous() for l in range(L)]
    vs = [vc[l, :pos + 1].reshape(pos + 1, B, NH, hd).permute(1, 2, 0, 3)
          .contiguous() for l in range(L)]
    qh = q.reshape(B, NH, 1, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = time_ms(lambda i: sdpa(qh, ks[i % L], vs[i % L]), 240)
    n_bytes = k1_bytes(pos, B, int8=False)
    rate = n_bytes / (kernel / 1e3)   # bytes per second
    print(f'K1 bf16 pos {pos} B {B}: kernel {kernel:.5f} ms moves the '
          f'bound\'s {n_bytes / 2**20:.2f} MiB at {rate / 1e12:.3f} TB/s '
          f'({rate / HBM_BYTES_PER_S:.1%} of {HBM_BYTES_PER_S / 1e12:.2f} '
          f'TB/s)')
    return kernel, plain, library, bound(n_bytes, k1_flops(pos, B))


# K1-int8 check cases: (L, T, B, heads, positions). Every position of
# K1_CASES; on the flagship cache the int8 kernel's stage edges +-1
# (stages of 16 buffer rows, the new token's row first) and positions whose
# last step of 8 rows is partly filled (9, 14, 40); its round edges (64
# rows) +-1 and stage edges on a longer cache; the pipelined batch 1024 (4
# heads a block); and head dim 32 (48 heads of d 1536) through the stages
# and rounds.
K1_INT8_CASES = ((L, T, B, NH, (0, 1, 7, 8, 9, 14, 15, 16, 17, 31, 32, 33,
                                40, 47, 48, 49, 63)),
                 (2, 160, 8, NH, (63, 64, 65, 79, 80, 81, 127, 128, 129,
                                  159)),
                 (2, T, B_LARGE, NH, (33, 63)),
                 (2, 160, 8, 2 * NH, (0, 17, 33, 64, 129, 159)))


def check_decode_attention_int8(da):
    """K1's int8 kernel: int8 caches and new rows over the full range
    -128..127, f32 or bf16 q, at K1_INT8_CASES: caches bit-equal, y within
    the tolerance in units of 1/127. Then a q with a NaN in one head and
    an infinity in another: y NaN exactly where the plain version's is."""
    max_err = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for n_layers, n_rows, batch, n_heads, positions in K1_INT8_CASES:
            for pos in positions:
                g = torch.Generator(device='cuda').manual_seed(pos)

                def randint8(*shape):
                    return torch.randint(-128, 128, shape, generator=g,
                                         device='cuda', dtype=torch.int8)

                kc = randint8(n_layers, n_rows, batch, D)
                vc = randint8(n_layers, n_rows, batch, D)
                kn, vn = randint8(batch, D), randint8(batch, D)
                q = (torch.randn((batch, D), generator=g, device='cuda') *
                     0.02).to(dtype)
                layer = pos % n_layers
                kc1, vc1 = kc.clone(), vc.clone()
                y1 = da.decode_attention_step(q, kn, vn, kc1, vc1, layer,
                                              pos, n_heads)
                y2 = da.decode_attention_step_plain(q, kn, vn, kc, vc, layer,
                                                    pos, n_heads)
                torch.cuda.synchronize()
                require(torch.equal(kc1, kc) and torch.equal(vc1, vc),
                        f'K1 int8 cache rows differ ({dtype} q, T {n_rows}, '
                        f'B {batch}, pos {pos})')
                # y is in the int8 values' units (|v| <= 128): compare it
                # dequantized by a V scale of 1/127, as the caller scales it
                y1, y2 = y1.float() / 127, y2.float() / 127
                err = (y1 - y2).abs().max().item()
                torch.testing.assert_close(y1, y2, atol=tol, rtol=tol)
                max_err[dtype] = max(max_err.get(dtype, 0.0), err)
                print(f'K1 int8 cache, {str(dtype):14s} q T={n_rows:3d} '
                      f'B={batch:4d} hd={D // n_heads} pos={pos:3d}: caches '
                      f'bit-equal, max|y - plain| / 127 = {err:.3e} (tol '
                      f'{tol})')
                del kc, vc, kc1, vc1
    g = torch.Generator(device='cuda').manual_seed(5)
    kc, vc = (torch.randint(-128, 128, (L, T, B, D), generator=g,
                            device='cuda', dtype=torch.int8)
              for _ in range(2))
    kn, vn = (torch.randint(-128, 128, (B, D), generator=g, device='cuda',
                            dtype=torch.int8) for _ in range(2))
    hd = D // NH
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((B, D), generator=g, device='cuda').to(dtype)
        q[0, 3] = float('nan')
        q[1, hd + 5] = float('inf')
        q[2, 2 * hd] = -float('inf')
        y1 = da.decode_attention_step(q, kn, vn, kc.clone(), vc.clone(), 1,
                                      TIMED_POS, NH)
        y2 = da.decode_attention_step_plain(q, kn, vn, kc.clone(),
                                            vc.clone(), 1, TIMED_POS, NH)
        require(torch.equal(y1.isnan(), y2.isnan()) and
                bool(y2.isnan().any()),
                f'K1 int8 cache, {dtype} q: NaN in y '
                f'({int(y1.isnan().sum())}) differs from the plain '
                f'version\'s ({int(y2.isnan().sum())}) for a non-finite q')
        print(f'K1 int8 cache, {str(dtype):14s} q with NaN and inf: '
              f'{int(y1.isnan().sum())} NaN in y, as the plain version')
    return max_err[torch.bfloat16]


def time_decode_attention_int8(da):
    """int8 caches with a bf16 q at pos 33, batch 128, the layer rotating
    over all 12, beside the bf16 kernel on a bf16 cache of the same values
    in the same call. No single PyTorch call attends over an int8 cache,
    so the library time is None; bf16 SDPA over the dequantized cache is
    printed for context."""
    g = torch.Generator(device='cuda').manual_seed(2)
    kc, vc = (torch.randint(-128, 128, (L, T, B, D), generator=g,
                            device='cuda', dtype=torch.int8)
              for _ in range(2))
    kn, vn = (torch.randint(-128, 128, (B, D), generator=g, device='cuda',
                            dtype=torch.int8) for _ in range(2))
    q = (torch.randn((B, D), generator=g, device='cuda') * 0.02).bfloat16()
    pos, hd = TIMED_POS, D // NH
    kernel = time_ms(lambda i: da.decode_attention_step(
        q, kn, vn, kc, vc, i % L, pos, NH), 240)
    plain = time_ms(lambda i: da.decode_attention_step_plain(
        q, kn, vn, kc, vc, i % L, pos, NH), 24)
    kb, vb = kc.bfloat16(), vc.bfloat16()
    knb, vnb = kn.bfloat16(), vn.bfloat16()
    bf16 = time_ms(lambda i: da.decode_attention_step(
        q, knb, vnb, kb, vb, i % L, pos, NH), 240)
    ks = kb[:, :pos + 1].reshape(L, pos + 1, B, NH, hd).permute(
        0, 2, 3, 1, 4).contiguous()
    vs = vb[:, :pos + 1].reshape(L, pos + 1, B, NH, hd).permute(
        0, 2, 3, 1, 4).contiguous()
    qh = q.reshape(B, NH, 1, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    context = time_ms(lambda i: sdpa(qh, ks[i % L], vs[i % L]), 240)
    n_bytes = k1_bytes(pos, B, int8=True)
    bnd = bound(n_bytes, k1_flops(pos, B))
    rate = n_bytes / (kernel / 1e3)
    print(f'K1 int8 cache, bf16 q, pos {pos} B {B}: kernel {kernel:.5f} ms '
          f'({rate / 1e12:.3f} TB/s over the bound\'s {n_bytes / 2**20:.2f} '
          f'MiB), bound {bnd[0]:.5f} ms ({bnd[1]}; kernel '
          f'{kernel / bnd[0]:.2f}x), plain {plain:.4f} ms; the bf16 kernel '
          f'on the same values {bf16:.5f} ms in this call')
    print(f'K1 int8 library time: none (no PyTorch call attends over an '
          f'int8 cache); for context only, bf16 SDPA over the dequantized '
          f'cache {context:.5f} ms')
    return kernel, plain, None, bnd


# Every position the sampler launches K1 at: the spatial step of position
# i writes cache row i and attends over rows < i, i = 1..63
# (sampling/engine.py::_serving_loop), in each of the 12 layers.
K1_POSITIONS = range(1, T)
# The sweep's caches hold one layer per timed call, so that no call finds
# its rows in L2 from an earlier one (at pos 1 a pass over the layers reads
# 94 MB), as on the main path, where every layer's gemms run in between.
SWEEP_LAYERS = 240


def fit_line(xs, ys):
    """Least-squares (a, b) of y = a + b x."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) /
         sum((x - mx) ** 2 for x in xs))
    return my - b * mx, b


def sweep_decode_attention(da):
    """K1 on int8 caches and on bf16 caches of the same values, bf16 q,
    batch 128, at every position of K1_POSITIONS, each beside its bound;
    the fitted fixed and per-row costs; the sum over a batch's 756
    launches beside the summed bound."""
    g = torch.Generator(device='cuda').manual_seed(3)
    shape = (SWEEP_LAYERS, T, B, D)
    kc8, vc8 = (torch.randint(-128, 128, shape, generator=g, device='cuda',
                              dtype=torch.int8) for _ in range(2))
    kn8, vn8 = (torch.randint(-128, 128, (B, D), generator=g, device='cuda',
                              dtype=torch.int8) for _ in range(2))
    q = (torch.randn((B, D), generator=g, device='cuda') * 0.02).bfloat16()
    operands = {'int8': (kn8, vn8, kc8, vc8),
                'bf16': tuple(x.bfloat16() for x in (kn8, vn8, kc8, vc8))}
    times = {cache: [] for cache in operands}
    for pos in K1_POSITIONS:
        line = [f'K1 sweep pos {pos:2d}:']
        for cache, (kn, vn, kc, vc) in operands.items():
            ms = time_ms(lambda i: da.decode_attention_step(
                q, kn, vn, kc, vc, i % SWEEP_LAYERS, pos, NH), 240)
            bnd = bound(k1_bytes(pos, B, cache == 'int8'),
                        k1_flops(pos, B))[0]
            times[cache].append(ms)
            line.append(f'{cache} {ms:.5f} ms ({bnd / ms:.1%} of '
                        f'{bnd:.5f});')
        print(' '.join(line))
    positions = list(K1_POSITIONS)
    for cache in operands:
        bound_sum = L * sum(bound(k1_bytes(p, B, cache == 'int8'),
                                  k1_flops(p, B))[0] for p in positions)
        a, slope = fit_line(positions, times[cache])
        total = L * sum(times[cache])
        print(f'K1 sweep {cache} caches, B {B}: time = {a * 1e3:.3f} us + '
              f'{slope * 1e3:.4f} us x pos (fit over pos {positions[0]}..'
              f'{positions[-1]}); {len(positions) * L} launches of a batch '
              f'sum to {total:.4f} ms against a summed bound of '
              f'{bound_sum:.4f} ms ({bound_sum / total:.1%})')
    del operands, kc8, vc8
    torch.cuda.empty_cache()


def time_decode_attention_int8_large(da):
    """K1-int8 at batch 1024 (the pipelined int8max batch), pos 33, bf16 q,
    the layer rotating over all 12: 12,288 blocks, several waves."""
    g = torch.Generator(device='cuda').manual_seed(4)
    kc, vc = (torch.randint(-128, 128, (L, T, B_LARGE, D), generator=g,
                            device='cuda', dtype=torch.int8)
              for _ in range(2))
    kn, vn = (torch.randint(-128, 128, (B_LARGE, D), generator=g,
                            device='cuda', dtype=torch.int8)
              for _ in range(2))
    q = (torch.randn((B_LARGE, D), generator=g, device='cuda') *
         0.02).bfloat16()
    pos = TIMED_POS
    kernel = time_ms(lambda i: da.decode_attention_step(
        q, kn, vn, kc, vc, i % L, pos, NH), 120)
    n_bytes = k1_bytes(pos, B_LARGE, int8=True)
    bnd = bound(n_bytes, k1_flops(pos, B_LARGE))
    print(f'K1 int8 cache, bf16 q, pos {pos} B {B_LARGE}: kernel '
          f'{kernel:.5f} ms ({n_bytes / (kernel / 1e3) / 1e12:.3f} TB/s), '
          f'bound {bnd[0]:.5f} ms ({bnd[1]}; {bnd[0] / kernel:.1%} of it)')
    return kernel, bnd


def print_sass_conversions(so: Path, label: str) -> None:
    """Per kernel of the built library `so`, from `cuobjdump -sass`: its
    int-to-float conversions (I2F, I2FP, by opcode) and byte permutes
    (PRMT) in the SASS text."""
    from hqtransformer_tpu_torch.ops import cuda_build
    tool = Path(cuda_build._nvcc()).with_name('cuobjdump')
    if not tool.exists():
        print(f'  {label}: I2F count not measured (no cuobjdump)')
        return
    out = subprocess.run([str(tool), '-sass', str(so)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    parts = re.split(r'\n\s*Function : (\S+)\s*\n', out)
    names = subprocess.run(['c++filt'], input='\n'.join(parts[1::2]),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    print(f'  {label} SASS (cuobjdump):')
    for name, body in zip(names, parts[2::2]):
        ops = re.findall(r'/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?'
                         r'([A-Z][A-Z0-9]*(?:\.[A-Z0-9_]+)*)', body)
        conv = {}
        for op in ops:
            if op.startswith('I2F'):
                conv[op] = conv.get(op, 0) + 1
        n_i2f = sum(conv.values())
        n_prmt = sum(op.split('.')[0] == 'PRMT' for op in ops)
        name = name.replace('(anonymous namespace)::', '').split('(')[0]
        detail = ', '.join(f'{k} {v}' for k, v in sorted(conv.items()))
        print(f'    {name.removeprefix("void ")}: {len(ops)} instructions, '
              f'I2F {n_i2f}{f" ({detail})" if detail else ""}, PRMT '
              f'{n_prmt}')


# ---------------------------------------------------------- K2 top-k sample

# Operations of the K2 kernel per logit: the key, two radix-select passes
# (bf16) of a compare and a count each, the max, the value below the k-th,
# the divide, mask, exp, running sum and draw count.
K2_OPS_PER_LOGIT = 12


def k2_rows(kind: str, n: int, v: int, seed: int) -> torch.Tensor:
    """Seeded rows: 'random' N(0, 9); 'ties' integers, with exact ties at
    every rank; 'zeros' 90% +0.0 and -0.0 of random signs, so the k-th
    value is a signed zero for middle k; 'x30' random values scaled 30x,
    whose k-th value lies below row max - 44 for most k."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, v), generator=g) * 3
    if kind == 'ties':
        x = torch.round(x)
    elif kind == 'zeros':
        zero = torch.where(torch.rand((n, v), generator=g) < 0.5, -0.0, 0.0)
        x = torch.where(torch.rand((n, v), generator=g) < 0.9, zero, x)
    elif kind == 'x30':
        x = x * 30
    return x


K2_KINDS = ('random', 'ties', 'zeros', 'x30')


def check_sample_topk(st):
    """Every row kind in both dtypes at V 8192 and 1000, k in {1, 2, 2048,
    V - 1, V}, T 0.95, shared uniforms: the kernel's threshold output equals
    topk_threshold bit for bit; its kept set is the exact top-k within the
    window [max - 44, max] (all of the row for k >= V); every code lies in
    it; k=1 draws an argmax and equals plain; codes equal the plain
    version's except rows whose draw lies within 1e-5 of the row's mass
    from the CDF boundary between the two codes, at most 1% of rows."""
    temp, device = 0.95, 'cuda'
    max_err, worst_frac = 0, 0.0
    for vocab, n in ((V, 640), (1000, 256)):
        for kind_i, kind in enumerate(K2_KINDS):
            raw = k2_rows(kind, n, vocab, seed=vocab + kind_i).to(device)
            u = torch.rand(n, generator=torch.Generator().manual_seed(
                kind_i)).to(device)
            rows = torch.arange(n, device=device)
            for dtype in (torch.bfloat16, torch.float32):
                logits = raw.to(dtype)
                x = st.scaled_logits(logits, temp)
                row_max = x.amax(-1, keepdim=True)
                for k in (1, 2, 2048, vocab - 1, vocab):
                    k_eff = min(k, vocab)
                    thr_out = torch.empty(n, device=device)
                    c1 = st.sample_topk(logits, u, k, temp,
                                        threshold=thr_out).long()
                    c2 = st.sample_topk_plain(logits, u, k, temp).long()
                    thr = st.topk_threshold(x, k)
                    torch.cuda.synchronize()
                    case = f'{kind} {dtype} V={vocab} k={k}'
                    require(torch.equal(thr_out.view(torch.int32),
                                        thr[:, 0].view(torch.int32)),
                            f'K2 threshold differs from topk_threshold '
                            f'({case})')
                    kth = torch.topk(x, k_eff, dim=-1).values[:, -1:]
                    window = kth if k >= vocab else torch.maximum(
                        kth, row_max - st.BISECT_RANGE)
                    kept = x >= window
                    require(torch.equal(kept, x >= thr),
                            f'K2 kept set differs from top-k ({case})')
                    require(kept[rows, c1].all(),
                            f'K2 code outside the kept set ({case})')
                    n_differ, err = compare_draws(x, kept, u, c1, c2, k, case)
                    frac = n_differ / n
                    max_err = max(max_err, err)
                    worst_frac = max(worst_frac, frac)
                    print(f'K2 {kind:6s} {str(dtype):14s} V={vocab:4d} '
                          f'k={k:4d}: threshold bit-equal to topk_threshold; '
                          f'codes in the kept set; {n_differ} of {n} '
                          f'rows differ from plain, all at a CDF boundary')
    return max_err, worst_frac


def compare_draws(x, kept, u, c1, c2, k, case):
    """The kernel's codes c1 against the plain version's c2 on the scaled
    rows x with the kept set `kept`: k=1 draws an argmax on both; codes
    differ only in rows whose draw lies within 1e-5 of the row's mass from
    the CDF boundary between the two codes, at most 1% of rows. Returns
    (rows differing, max |c1 - c2|)."""
    n = x.shape[0]
    if k == 1:
        rows = torch.arange(n, device=x.device)
        require(torch.equal(x[rows, c1], x.amax(-1)),
                f'K2 k=1 drew no argmax ({case})')
        require(torch.equal(c1, c2), f'K2 k=1 differs from plain ({case})')
    differ = torch.nonzero(c1 != c2).flatten()
    if differ.numel():
        x64 = x[differ].double()
        p = torch.where(kept[differ], torch.exp(
            x64 - x64.amax(-1, keepdim=True)), 0.0)
        cdf = torch.cumsum(p, -1)
        total = cdf[:, -1]
        lo = torch.minimum(c1[differ], c2[differ])
        gap = (u[differ].double() * total -
               cdf.gather(1, lo[:, None])[:, 0]).abs() / total
        require((gap <= 1e-5).all(), f'K2 codes differ away from a CDF '
                f'boundary ({case}): {gap.max().item()}')
    require(differ.numel() <= 0.01 * n,
            f'K2 {differ.numel()} of {n} rows differ ({case})')
    return differ.numel(), (c1 - c2).abs().max().item()


def time_sample_topk(st):
    """bf16 at the main path's two shapes at batch 128, k 2048, T 0.95: the
    bottom-group draw [512, 8192] (the JSON entry) and the top draw
    [128, 8192]. Returns the bottom-group shape's (kernel, plain, library,
    bound)."""
    out = time_k2_shape(st, 4 * B)
    time_k2_shape(st, B)
    return out


def time_k2_shape(st, n, k=2048, temp=0.95):
    """K2 on seeded bf16 rows [n, 8192] beside its plain version, the
    library yardstick (a draw from the same top-k softmax with the same
    uniforms and no host wait: topk, softmax, cumsum, searchsorted) and
    its bound. Returns (kernel, plain, library, bound)."""
    g = torch.Generator(device='cuda').manual_seed(3)
    logits = (torch.randn((n, V), generator=g, device='cuda') * 3).to(
        torch.bfloat16)
    u = torch.rand(n, generator=g, device='cuda')
    kernel = time_ms(lambda i: st.sample_topk(logits, u, k, temp), 200)
    plain = time_ms(lambda i: st.sample_topk_plain(logits, u, k, temp), 5)

    def library(i):
        vals, idx = torch.topk(st.scaled_logits(logits, temp), k, dim=-1)
        cdf = torch.softmax(vals, dim=-1).cumsum(dim=-1)
        j = torch.searchsorted(cdf, u[:, None]).clamp_max_(k - 1)
        return idx.gather(1, j)

    lib = time_ms(library, 50)
    # bytes: the logits and u read once, the codes written once
    n_bytes = n * V * 2 + n * 8
    bnd = bound(n_bytes, K2_OPS_PER_LOGIT * n * V)
    print(f'K2 bf16 [{n}, {V}] k {k}: kernel {kernel:.5f} ms, plain '
          f'{plain:.4f} ms, topk+softmax+cumsum+searchsorted {lib:.5f} '
          f'ms, bound {bnd[0]:.5f} ms ({bnd[1]}); the kernel takes '
          f'{kernel / bnd[0]:.2f}x its bound')
    return kernel, plain, lib, bnd


# The 3-level sampler's draws at batch 128: the top [B, V], the mids
# [4B, V] and the bottoms [16B, V], bf16, top-k 2048 at temperature 1.0.
K2_LEVEL3_ROWS = (B, 4 * B, 16 * B)
K2_LEVEL3_K, K2_LEVEL3_TEMP = 2048, 1.0


def check_sample_topk_bisect3(st):
    """K2 with bisect3 (the quartile search) at the 3-level draw shapes:
    random and tied rows in bf16 at every shape, random rows in f32 at the
    mids' shape; k in {1, 2048}, T 1.0, shared uniforms. The threshold
    output equals `replay_threshold(bisect3=True)` (the plain replay of
    the kernel's select, `bisection3_replay`) and `topk_threshold3` (the
    quartile search over the logits) bit for bit; the kept set is the
    exact top-k within [max - 44, max]; codes lie in it and equal the
    plain version's but at CDF boundaries (as check_sample_topk). Returns
    the largest code difference."""
    temp, device = K2_LEVEL3_TEMP, 'cuda'
    max_err = 0
    cases = [(n, kind, torch.bfloat16) for n in K2_LEVEL3_ROWS
             for kind in ('random', 'ties')]
    cases.append((4 * B, 'random', torch.float32))
    for i, (n, kind, dtype) in enumerate(cases):
        logits = k2_rows(kind, n, V, seed=100 + i).to(device, dtype)
        u = torch.rand(n, generator=torch.Generator().manual_seed(i)).to(
            device)
        x = st.scaled_logits(logits, temp)
        row_max = x.amax(-1, keepdim=True)
        rows = torch.arange(n, device=device)
        for k in (1, K2_LEVEL3_K):
            thr_out = torch.empty(n, device=device)
            c1 = st.sample_topk(logits, u, k, temp, threshold=thr_out,
                                bisect3=True).long()
            c2 = st.sample_topk_plain(logits, u, k, temp, bisect3=True).long()
            replay = st.replay_threshold(logits, k, temp, bisect3=True)
            direct = st.topk_threshold3(x, k)
            torch.cuda.synchronize()
            case = f'bisect3 {kind} {dtype} [{n}, {V}] k={k}'
            for name, thr in (('bisection3_replay', replay),
                              ('topk_threshold3', direct)):
                require(torch.equal(thr_out.view(torch.int32),
                                    thr[:, 0].view(torch.int32)),
                        f'K2 threshold differs from {name} ({case})')
            kth = torch.topk(x, k, dim=-1).values[:, -1:]
            kept = x >= torch.maximum(kth, row_max - st.BISECT_RANGE)
            require(torch.equal(kept, x >= thr_out[:, None]),
                    f'K2 kept set differs from top-k ({case})')
            require(kept[rows, c1].all(),
                    f'K2 code outside the kept set ({case})')
            n_differ, err = compare_draws(x, kept, u, c1, c2, k, case)
            max_err = max(max_err, err)
            binary = (st.topk_threshold(x, k)[:, 0] != thr_out).sum().item()
            print(f'K2 {case}: threshold bit-equal to bisection3_replay and '
                  f'topk_threshold3 ({binary} of {n} rows end on other bits '
                  f'than the binary search); codes in the kept set; '
                  f'{n_differ} rows differ from plain, all at a CDF boundary')
    return max_err


def time_sample_topk_level3(st):
    """bf16 K2 at the 3-level draw shapes, k 2048, T 1.0, with the binary
    and the quartile search, beside the plain version (quartile) and the
    library yardstick of time_sample_topk. Returns the mids shape's
    (kernel, plain, library, bound) with bisect3, for the JSON line."""
    k, temp = K2_LEVEL3_K, K2_LEVEL3_TEMP
    out = None
    for n in K2_LEVEL3_ROWS:
        g = torch.Generator(device='cuda').manual_seed(5)
        logits = (torch.randn((n, V), generator=g, device='cuda') * 3).to(
            torch.bfloat16)
        u = torch.rand(n, generator=g, device='cuda')
        ms = {False: [], True: []}
        for b3 in (False, True, True, False):  # in turns
            ms[b3].append(time_ms(lambda i: st.sample_topk(
                logits, u, k, temp, bisect3=b3), 200))
        binary, quartile = (sum(ms[b3]) / 2 for b3 in (False, True))
        plain = time_ms(lambda i: st.sample_topk_plain(
            logits, u, k, temp, bisect3=True), 3)

        def library(i):
            vals, idx = torch.topk(st.scaled_logits(logits, temp), k, dim=-1)
            cdf = torch.softmax(vals, dim=-1).cumsum(dim=-1)
            j = torch.searchsorted(cdf, u[:, None]).clamp_max_(k - 1)
            return idx.gather(1, j)

        lib = time_ms(library, 50)
        bnd = bound(n * V * 2 + n * 8, K2_OPS_PER_LOGIT * n * V)
        print(f'K2 bf16 [{n}, {V}] k {k} T {temp}: binary {binary:.5f} ms, '
              f'bisect3 {quartile:.5f} ms ({quartile / binary:.3f}x), plain '
              f'(bisect3) {plain:.4f} ms, topk+softmax+cumsum+searchsorted '
              f'{lib:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}); bisect3 '
              f'takes {quartile / bnd[0]:.2f}x its bound')
        if n == 4 * B:
            out = (quartile, plain, lib, bnd)
    return out


# ----------------------------------------------------- K3 nearest-code search

def compare_codes(z, e, c1, c2, max_share=1e-3):
    """Rows where codes c1 and c2 differ must be near-ties: their two
    squared distances, recomputed in f64, within NEAR_TIE (|z|^2 + |e|^2);
    at most `max_share` of rows. Returns (rows differing, max f64 distance
    gap)."""
    rows = torch.nonzero(c1 != c2).flatten()
    if rows.numel() == 0:
        return 0, 0.0
    z64, e1, e2 = z[rows].double(), e[c1[rows]].double(), e[c2[rows]].double()
    gap = ((z64 - e1).square().sum(1) - (z64 - e2).square().sum(1)).abs()
    scale = z64.square().sum(1) + torch.maximum(e1.square().sum(1),
                                                e2.square().sum(1))
    require(bool((gap <= NEAR_TIE * scale).all()),
            f'K3 codes differ away from a near-tie: gap {gap.max().item()}')
    require(rows.numel() <= max_share * z.shape[0],
            f'K3 {rows.numel()} of {z.shape[0]} rows differ')
    return rows.numel(), gap.max().item()


def check_vq_argmin(vq):
    N = 8191   # ragged: not a multiple of the kernel's 128-row tile
    max_err = 0.0
    # Every pair runs the wgmma kernel: f32 x f32 over 6 pairs of bf16
    # pieces, a mixed pair over 3, bf16 x bf16 over 1; D = 40 and 200 leave
    # a ragged tail of its 64-column chunks, and the small cases have fewer
    # rows and codes than one of its TMA boxes.
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(N, D, K, dt, dt) for D in (256, 1024, 4096)
             for K in (N_CODES, 1000) for dt in (f32, bf16)]
    cases += [(N, 256, K, zt, et) for K in (N_CODES, 1000)
              for zt, et in ((f32, bf16), (bf16, f32))]
    cases += [(N, 40, 1000, bf16, bf16), (N, 200, N_CODES, bf16, bf16),
              (37, 64, 1000, bf16, bf16), (100, 32, 100, bf16, bf16)]
    for n, D, K, z_dtype, e_dtype in cases:
        g = torch.Generator(device='cuda').manual_seed(D + K)
        z = torch.randn((n, D), generator=g, device='cuda').to(z_dtype)
        e = torch.randn((K, D), generator=g, device='cuda').to(e_dtype)
        c1 = vq.vq_argmin(z, e)
        c2 = vq.vq_argmin_plain(z, e)
        torch.cuda.synchronize()
        n_diff, err = compare_codes(z, e, c1, c2)
        max_err = max(max_err, err)
        pair = f'{str(z_dtype)[6:]} z, {str(e_dtype)[6:]} e'
        print(f'K3 N={n:4d} D={D:4d} K={K:4d} {pair:20s} '
              f'({pair_list(vq, z_dtype, e_dtype)}): {n_diff} of {n} '
              f'rows differ from plain, each a near-tie')
    # Exact ties: integer values keep every distance exact in f32 whatever
    # the summation order. Code c equals codes c^1 and c^1 +- K/2.
    g = torch.Generator(device='cuda').manual_seed(11)
    base = torch.randint(-3, 4, (N_CODES // 4, 256), generator=g,
                         device='cuda').repeat_interleave(2, dim=0)
    e = torch.cat([base, base]).float()
    z = torch.randint(-3, 4, (N, 256), generator=g, device='cuda').float()
    for dtype in (torch.float32, torch.bfloat16):
        c1 = vq.vq_argmin(z.to(dtype), e.to(dtype))
        c2 = vq.vq_argmin_plain(z.to(dtype), e.to(dtype))
        torch.cuda.synchronize()
        require(torch.equal(c1, c2), f'K3 exact ties resolved differently '
                f'from plain ({dtype})')
        require(bool((c1 % 2 == 0).all() and (c1 < N_CODES // 2).all()),
                f'K3 exact ties not resolved to the lowest index ({dtype})')
        print(f'K3 exact ties {str(dtype):14s} '
              f'({pair_list(vq, dtype, dtype)}): equal to plain, every '
              f'row on the lowest index of its tie')
    return max_err


def pair_list(vq, z_dtype, e_dtype) -> str:
    """The pairs of bf16 pieces (z, codebook) the kernel sums for a dtype
    pair, e.g. '3 pairs: hi.hi hi.mid hi.lo'."""
    names = ('hi', 'mid', 'lo')
    pairs = vq.piece_pairs(vq.kernel_variant(z_dtype, e_dtype))
    return (f'{len(pairs)} pair{"s" if len(pairs) > 1 else ""}: ' +
            ' '.join(f'{names[p]}.{names[q]}' for p, q in pairs))


def extra_peak_mib(fn) -> float:
    """Device memory one call of fn allocates at its peak beyond what is
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def time_vq_argmin(vq, dtype):
    """z and codebooks in `dtype` at each K3_SHAPES shape: first the
    kernel's codes against the plain version's on these inputs (the
    near-tie rule of compare_codes), then the times. The library yardstick
    is cuBLAS SGEMM (TF32 off) + argmin, which writes the [N, K] f32 score
    matrix; the port never calls it. The bound, in either dtype: the
    function's one pass of 2 N K D operations at the highest tensor-core
    rate the kernel runs on, bf16's (a bf16 x bf16 product is exact in
    f32, so bf16 wgmma with f32 accumulation gives the same scores up to
    summation order; f32 scores need no more than one argmin over them
    either, whatever passes a design spends). The design's own floor, its
    passes at that rate (six in f32), is printed on a line of its own.
    Returns (one (ms, plain, lib, bound, memory, rows differing) per
    shape, max f64 gap)."""
    out, max_err = [], 0.0
    name_dt = str(dtype)[6:]
    passes = len(vq.piece_pairs(vq.kernel_variant(dtype, dtype)))
    for name, N, D in K3_SHAPES:
        g = torch.Generator(device='cuda').manual_seed(N + D)
        z = torch.randn((N, D), generator=g, device='cuda').to(dtype)
        e = torch.randn((N_CODES, D), generator=g, device='cuda').to(dtype)
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = vq.codebook_splits(N, N_CODES, n_sms)
        n_diff, err = compare_codes(z, e, vq.vq_argmin(z, e),
                                    vq.vq_argmin_plain(z, e))
        max_err = max(max_err, err)
        print(f'K3 {name} N={N} D={D} {name_dt} '
              f'({pair_list(vq, dtype, dtype)}), {splits} codebook slices: '
              f'{n_diff} of {N} rows differ from plain, each a near-tie')

        def library(i=0):
            ef = e.float()
            return torch.addmm(ef.square().sum(1), z.float(), ef.T,
                               alpha=-2).argmin(1)

        def kernel(i=0):
            return vq.vq_argmin(z, e)

        ms = time_ms(kernel, 10 if passes == 1 else 5)
        plain = time_ms(lambda i: vq.vq_argmin_plain(z, e), 3)
        lib = time_ms(library, 10)
        mem = (extra_peak_mib(kernel), extra_peak_mib(library))
        # bytes: z and e read once, the codes written once; operations:
        # one multiply and one add per (row, code, dim), at the bf16 rate.
        n_bytes = (N + N_CODES) * D * z.element_size() + N * 8
        flops = 2 * N * N_CODES * D
        bnd = bound(n_bytes, flops, BF16_FLOPS_PER_S)
        out.append((ms, plain, lib, bnd, mem, n_diff))
        print(f'K3 {name} N={N} K={N_CODES} D={D} {name_dt}: kernel '
              f'{ms:.4f} ms ({passes * flops / ms / 1e9:.1f} TFLOP/s over '
              f'{passes} bf16 pass{"es" if passes > 1 else ""}), plain '
              f'{plain:.4f} ms, addmm+argmin {lib:.4f} ms, bound '
              f'{bnd[0]:.4f} ms ({bnd[1]}, one bf16 pass; kernel '
              f'{ms / bnd[0]:.2f}x); extra peak memory kernel '
              f'{mem[0]:.2f} MiB, addmm+argmin {mem[1]:.1f} MiB')
        if passes > 1:
            floor = bound(n_bytes, passes * flops, BF16_FLOPS_PER_S)[0]
            print(f'K3 {name} {name_dt} design floor: {passes} bf16 passes '
                  f'at the bf16 rate {floor:.4f} ms (kernel '
                  f'{ms / floor:.2f}x); not a bound of the function')
        if passes == 1:
            # Yardstick outside the JSON: cuBLAS's bf16 GEMM alone. It is
            # not the same function (no argmin, and it writes the [N, K]
            # matrix).
            gemm = time_ms(lambda i: torch.matmul(z, e.T), 10)
            print(f'K3 {name} yardstick: bf16 cuBLAS z @ e.T alone '
                  f'{gemm:.4f} ms ({flops / gemm / 1e9:.1f} TFLOP/s); the '
                  f'kernel takes {ms / gemm:.2f}x its time')
        del z, e
    return out, max_err


def flagship_entry(shapes):
    """A K3 entry of the JSON line: the mean of one launch at each of the
    flagship's two levels (the first two K3_SHAPES)."""
    flagship = shapes[:2]
    return tuple(sum(t[i] for t in flagship) / 2 for i in range(3)) + (
        (sum(t[3][0] for t in flagship) / 2, flagship[0][3][1]),)


# ------------------------------------------------------------ main path

@contextlib.contextmanager
def k1_positions():
    """The positions at which the spatial steps launch K1 while the
    context is open (a spy on the name `layers.step` calls)."""
    from hqtransformer_tpu_torch.models.stage2 import layers
    real, seen = layers.decode_attention_step, []

    def spy(*args, **kwargs):
        seen.append(args[6])
        return real(*args, **kwargs)
    layers.decode_attention_step = spy
    try:
        yield seen
    finally:
        layers.decode_attention_step = real


def sampling_shape(model):
    """(N spatial positions, K2 draws a position, the code shapes of one
    sample) of a sampling call of `model`'s stage 2 at its full length: the
    flat baselines one code a position (Transformer1d over ctx_len_img
    bottom codes); the 2-level family a top and its ratio bottoms, drawn
    in len_seq_depth draws (`parallel`: 2; `top2bot`: 1 + ratio) or one
    joint draw (`bidirectional`); the 3-level family three draws."""
    from hqtransformer_tpu_torch.models.stage2.transformer import (
        IGPT, Transformer1d)

    s2 = model.stage2
    if isinstance(s2, Transformer1d):
        n = model.config.stage2.hparams.ctx_len_img
        return n, 1, [(n,)]
    n = model.top_res * model.top_res
    if model.code_levels == 3:
        return n, 3, [(n,), (n, 4), (n, 16)]
    if isinstance(s2, IGPT):
        return n, 1, [(n,)]
    draws = 1 if s2.depth_mode == 'bidirectional' else s2.len_seq_depth
    return n, draws, [(n,), (n, s2.ratio_bot2top)]


def gn_count(stage1, part):
    """The GroupNorms of `stage1`'s `part` ('encoder' or 'decoder'): the
    GroupNorm kernel pairs one pass of it launches outside autograd."""
    from hqtransformer_tpu_torch.models.stage1.layers import GroupNorm
    return sum(isinstance(m, GroupNorm)
               for m in getattr(stage1, part).modules())


def checked_call(model, call, labels, name, da, st, q8, int8=False,
                 bisect3=False, top_p=False, a8w8=None, stage1=None,
                 decode_chunk=128):
    """One call of a sampler, checked: `call()` gives (pixels, codes) for
    `labels`' batch n, codes one tensor or a tuple of the levels' (see
    `sampling_shape`: N positions, each of the shapes there with a leading
    n) in [0, 8192); pixels [n, res, res, 3] finite in [0, 1];
    n_layers x (N - 1) K1 launches at pos sos_len .. sos_len + N - 2 (all
    on the int8 variant with `int8`); draws x N K2 launches (all with the
    quartile search with `bisect3`; none with `top_p`, whose draws leave
    the kernel as in JAX); int8 gemms and convolutions counted with
    `int8`, none without, unless `a8w8` says which of the two must run
    (the flat baselines' int8 cache runs no gemm); the GroupNorm kernel
    once at each GroupNorm of `stage1`'s decoder (`model.stage1` unless
    given) in each `decode_chunk`-sample chunk of the n samples
    (`gn.launches`), and no layout copy (`gn.layout_copies`). Prints
    samples/s and peak memory; returns (codes, samples/s)."""
    n = labels.shape[0]
    n_top, draws, sample_shapes = sampling_shape(model)
    res = model.config.dataset.image_resolution
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts('k1.launches', 'k2.launches', 'int8.matmul_launches',
                 'int8.conv2d_launches', 'k1.int8_launches',
                 'k2.bisect3_launches', 'gn.launches', 'gn.layout_copies')
    with k1_positions() as positions:
        t0 = time.perf_counter()
        pixels, codes = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    k1 = model.config.stage2.hparams.n_layers * (n_top - 1)
    k2 = 0 if top_p else draws * n_top
    launches = (since_reset('k1.launches'),
                since_reset('k1.int8_launches'),
                since_reset('k2.launches'), since_reset('k2.bisect3_launches'))
    want = (k1, k1 if int8 else 0, k2, k2 if bisect3 else 0)
    require(launches == want, f'{name} launches K1, K1 int8, K2, K2 '
            f'bisect3 {launches}, expected {want}')
    first = model.stage2.sos_len
    span = (min(positions), max(positions)) if positions else None
    require(len(positions) == k1 and span == (first, first + n_top - 2),
            f'{name} K1 at pos {span}, expected {first}..'
            f'{first + n_top - 2}')
    gemms = since_reset('int8.matmul_launches')
    convs = since_reset('int8.conv2d_launches')
    require((gemms > 0, convs > 0) == ((int8, int8) if a8w8 is None
                                       else a8w8),
            f'{name} int8 gemms, convs {(gemms, convs)}')
    gn = (since_reset('gn.launches'), since_reset('gn.layout_copies'))
    gn_want = (gn_count(stage1 or model.stage1, 'decoder') *
               -(-n // decode_chunk), 0)
    require(gn == gn_want, f'{name} GroupNorm kernel pairs, layout copies '
            f'{gn}, expected {gn_want}')
    levels = codes if isinstance(codes, tuple) else (codes,)
    shapes = [(n,) + s for s in sample_shapes]
    require([tuple(c.shape) for c in levels] == shapes,
            f'{name} code shapes {[tuple(c.shape) for c in levels]}')
    for c in levels:
        require(int(c.min()) >= 0 and int(c.max()) < N_CODES,
                f'{name} codes outside [0, {N_CODES})')
    require(pixels.shape == (n, res, res, 3),
            f'{name} pixel shape {tuple(pixels.shape)}')
    require(bool(torch.isfinite(pixels).all()), f'{name} pixels not finite')
    require(float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0,
            f'{name} pixels outside [0, 1]')
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f'{name}: {seconds:.3f} s, {n / seconds:.2f} samples/s at batch '
          f'{n}, peak {peak:.2f} GiB, launches K1={launches[0]} (int8 '
          f'{launches[1]}, pos {span[0]}..{span[1]}) K2={launches[2]} '
          f'(bisect3 {launches[3]}), int8 gemms {gemms}, int8 convs {convs}, '
          f'GroupNorm kernels {gn[0]} (no layout copy)')
    return codes, n / seconds


def sampler_call(model, weights, sampler, gen, labels, name, da, st, q8,
                 **kinds):
    """`checked_call` of `sampler(weights, gen, labels)`."""
    return checked_call(model, lambda: sampler(weights, gen, labels), labels,
                        name, da, st, q8, **kinds)


def bf16_model(config_path, labels_of):
    """A TwoStageModel at full width in bf16 with seeded random bf16
    serving weights, and `labels_of(config)` on the card."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.models.twostage import (TwoStageModel,
                                                         serving_bf16_params)

    cfg = build_twostage_config(str(config_path))
    model = TwoStageModel(cfg, dtype=torch.bfloat16)
    weights = {s: serving_bf16_params(w)
               for s, w in model.init_weights(seed=0).items()}
    return model, weights, labels_of(cfg).cuda()


SAMPLING_2048 = dict(top_k_top=2048, top_k_bot=2048, temperature_top=0.95,
                     temperature_bot=0.95)


def run_main_path(da, st):
    from hqtransformer_tpu_torch.ops import int8 as q8
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    model, weights, labels = bf16_model(
        FLAGSHIP, lambda cfg: torch.arange(B) % cfg.stage2.hparams.n_classes)
    params = SamplingParams(**SAMPLING_2048)
    sampler = model.make_pixel_sampler(params=params)
    gen = torch.Generator(device='cuda').manual_seed(1)
    for call in (1, 2):
        _, samples_per_s = sampler_call(model, weights, sampler, gen,
                                        labels, f'main path call {call}',
                                        da, st, q8)
    launches = (since_reset('k1.launches'), since_reset('k2.launches'))
    breakdown(model, weights, params, labels, gen)
    return launches, samples_per_s, model, weights


def breakdown(model, weights, params, labels, gen, name=''):
    """Where one batch's time goes: the AR loop (stage 2) and the stage-1
    decode, each timed alone on the host clock, then run once more under
    torch.profiler for the device's busy time and its largest kernels;
    `name` prefixes the phases' lines."""
    from hqtransformer_tpu_torch.models.stage2.hierarchical import \
        cells_to_raster
    from hqtransformer_tpu_torch.sampling.engine import \
        make_hierarchical_sampler

    model.load_weights(weights)
    n_top, win = model.top_res, model.cell_win
    sampler = make_hierarchical_sampler(model.stage2, n_top * n_top, params)
    codes = sampler(gen, labels)

    @torch.inference_mode()
    def decode():
        ct = codes[0].reshape(-1, n_top, n_top)
        cb = cells_to_raster(codes[1], n_top, win).reshape(
            -1, n_top * win, n_top * win)
        return model.stage1.decode_code(ct, cb)

    profile_phases(((f'{name}AR loop', lambda: sampler(gen, labels)),
                    (f'{name}stage-1 decode', decode)))


def profile_phases(phases):
    """Each (name, fn) timed alone on the host clock, then run once more
    under torch.profiler for the device's busy time and its largest
    kernels. Returns {name: {kernel name: (runs, device ms)}}."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in phases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        per_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = per_kernel.get(e.name, (0, 0.0))
                per_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
        per_kernel = {k: (n, us / 1e3) for k, (n, us) in per_kernel.items()}
        busy_ms = sum(ms for _, ms in per_kernel.values())
        print(f'breakdown {name}: {wall_ms:.1f} ms wall; device busy '
              f'{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}) in '
              f'{sum(n for n, _ in per_kernel.values())} kernel runs')
        ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
        # the six largest, and the port's own kernels wherever they rank
        for rank, (kname, (n, ms)) in enumerate(ranked):
            if rank < 6 or any(k in kname for k in PORT_KERNELS):
                print(f'  {ms:8.2f} ms {n:6d}x  {kname[:90]}')
        out[name] = per_kernel
    return out


# ------------------------------------------------------- int8max serving

def check_int8_products(q8):
    """The A8W8 products on the card against the CPU on the same int8
    inputs: `_int_mm` at the flagship's fused-QKV and first MLP gemm
    shapes (batch 128 rows), and the int8 convolution at the decoder's
    largest (128 channels at 256^2, 2 images, 3x3). int32 results (and the
    convolution's dequantized output) must be equal."""
    g = torch.Generator(device='cuda').manual_seed(12)
    for M, K, N in ((B, D, 3 * D), (B, D, 4 * D)):
        a = torch.randint(-127, 128, (M, K), generator=g, device='cuda',
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (N, K), generator=g, device='cuda',
                          dtype=torch.int8)
        card = q8.int_mm(a, w)
        require(torch.equal(card.cpu(), q8.int_mm(a.cpu(), w.cpu())),
                f'int8 gemm [{M}, {K}] x [{K}, {N}] differs from the CPU')
        print(f'int8 gemm [{M}, {K}] x [{K}, {N}]: int32 result equal to '
              f'the CPU\'s')
    x = torch.randn((2, 128, 256, 256), generator=g, device='cuda').bfloat16()
    w = (torch.randn((128, 128, 3, 3), generator=g, device='cuda') *
         0.03).bfloat16()
    bias = torch.randn(128, generator=g, device='cuda') * 0.1
    scale = q8.scale_from_absmax(q8.absmax(x))
    card = q8.Int8Weight.from_float(w, bias, scale)
    cpu = q8.Int8Weight.from_float(w.cpu(), bias.cpu(), scale.cpu())
    require(torch.equal(card.wq.cpu(), cpu.wq), 'int8 conv weights differ')
    xq = q8.quant_per_tensor(x, scale)
    require(torch.equal(xq.cpu(), q8.quant_per_tensor(x.cpu(), scale.cpu())),
            'int8 quantized activations differ from the CPU')
    cols = torch.nn.functional.pad(xq.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([cols[:, i:i + 256, j:j + 256] for i in range(3)
                      for j in range(3)], dim=-1).reshape(-1, 9 * 128)
    acc = q8.int_mm(cols, card.wq)
    require(torch.equal(acc.cpu(), q8.int_mm(cols.cpu(), cpu.wq)),
            'int8 conv int32 products differ from the CPU')
    y = q8.int8_conv2d(x, card, (3, 3), (1, 1), (1, 1))
    y_cpu = q8.int8_conv2d(x.cpu(), cpu, (3, 3), (1, 1), (1, 1))
    require(torch.equal(y.cpu(), y_cpu), 'int8 conv output differs from '
            'the CPU')
    print('int8 conv [2, 128, 256, 256] 3x3 -> 128: int32 products and '
          'bf16 output equal to the CPU\'s')


def calibrate_int8max(model, weights, params, labels):
    """The three calibrations at the flagship, on one bf16 sampling run's
    codes (the KV calibration and the run share a generator seed, so they
    draw the same codes), then the artifact saved and loaded back; returns
    the loaded scales."""
    from hqtransformer_tpu_torch.models.stage2.hierarchical import \
        cells_to_raster
    from hqtransformer_tpu_torch.models.twostage import (load_serving_scales,
                                                         save_serving_scales)
    from hqtransformer_tpu_torch.sampling.engine import \
        make_hierarchical_sampler

    n_top, win = model.top_res, model.cell_win
    t0 = time.perf_counter()
    scales = model.calibrate_kv_scales(
        weights, torch.Generator(device='cuda').manual_seed(7), labels,
        params)
    codes_t, codes_b = make_hierarchical_sampler(
        model.stage2, n_top * n_top, params)(
            torch.Generator(device='cuda').manual_seed(7), labels)
    raster = cells_to_raster(codes_b, n_top, win)
    scales.update(model.calibrate_stage2_int8(weights, codes_t,
                                              raster.reshape(B, -1), labels))
    scales.update(model.calibrate_int8_decode(
        weights, codes_t.reshape(-1, n_top, n_top),
        raster.reshape(-1, n_top * win, n_top * win)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    SCALES_PATH.parent.mkdir(parents=True, exist_ok=True)
    save_serving_scales(scales, str(SCALES_PATH))
    loaded = load_serving_scales(str(SCALES_PATH))
    require(sorted(loaded) == sorted(scales) and all(
        torch.equal(loaded[k][n], scales[k][n].cpu())
        for k in scales for n in scales[k]),
        'serving scales changed through the artifact')
    counts = ', '.join(f'{k} {len(v)}' for k, v in sorted(loaded.items()))
    print(f'int8max calibration at batch {B}: {seconds:.2f} s ({counts} '
          f'scales), saved to {SCALES_PATH.relative_to(ROOT)} and loaded '
          f'back bit for bit')
    return loaded


def run_pipelined(model, weights, params, labels, int8, scales, name, da, st,
                  q8, prev=None):
    """Calls of make_pipelined_sampler: a fill call unless `prev` codes
    are given, then steady calls (two at batch 128, one at another batch).
    Checks each call's codes, pixels and launch counts; returns the last
    call's codes."""
    sampler = model.make_pipelined_sampler(params=params, int8=int8,
                                           scales=scales)
    gen = torch.Generator(device='cuda').manual_seed(11)
    calls = ('steady',) if prev is not None else ('fill', 'steady', 'steady')
    codes = prev
    for kind in calls:
        last = None if kind == 'fill' else codes
        codes, _ = checked_call(
            model, lambda: sampler(weights, gen, labels, last)[::-1], labels,
            f'{name} pipelined {kind} call at batch {labels.shape[0]}', da,
            st, q8, int8=int8.kv_cache)
    return codes


def int8max_breakdown(model, weights, params, labels, int8, scales, codes):
    """The int8max AR loop and the int8 stage-1 decode, each timed alone
    and profiled (as phase 3's breakdown)."""
    from hqtransformer_tpu_torch.models.stage2.hierarchical import \
        cells_to_raster
    from hqtransformer_tpu_torch.sampling.engine import \
        make_hierarchical_sampler

    model.load_weights(weights)
    n_top, win = model.top_res, model.cell_win
    sampler = make_hierarchical_sampler(model.stage2, n_top * n_top, params,
                                        int8, scales)
    gen = torch.Generator(device='cuda').manual_seed(13)
    ct = codes[0].reshape(-1, n_top, n_top)
    cb = cells_to_raster(codes[1], n_top, win).reshape(
        -1, n_top * win, n_top * win)

    @torch.inference_mode()
    def decode():
        with model.stage1.int8_decode(scales['stage1/act_scales']):
            return model.stage1.decode_code(ct, cb)

    profile_phases((('int8max AR loop', lambda: sampler(gen, labels)),
                    ('int8 stage-1 decode', decode)))


def int8max_agreement(model, weights, codes, labels, scales, q8):
    """The bf16 run's codes through the scorer in bf16 and in int8max:
    top-1 agreement of the per-step logits and mean KL(bf16 || int8max)
    per step."""
    from hqtransformer_tpu_torch.sampling.engine import \
        make_hierarchical_scorer

    model.load_weights(weights)
    n_top = model.top_res * model.top_res
    out = {}
    for name, int8 in (('bf16', q8.Int8Serving()), ('int8max', q8.INT8MAX)):
        out[name] = make_hierarchical_scorer(model.stage2, n_top, int8,
                                             scales)(labels, *codes)
    for i, level in enumerate(('top', 'bottom')):
        a, b = out['bf16'][i].float(), out['int8max'][i].float()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        logp, logq = torch.log_softmax(a, -1), torch.log_softmax(b, -1)
        kl = (logp.exp() * (logp - logq)).sum(-1).mean().item()
        require(bool(torch.isfinite(b).all()), 'int8max logits not finite')
        print(f'int8max vs bf16 scorer, {level} logits {tuple(b.shape)}: '
              f'top-1 agreement {agree:.4f}, mean KL {kl:.3e} (random '
              f'weights)')


def run_int8max(da, st, model, weights):
    """Phase 7: int8max serving at the flagship. Returns K1-int8's check
    error, times and launches per int8max batch."""
    from hqtransformer_tpu_torch.ops import int8 as q8
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    k1_err = check_decode_attention_int8(da)
    k1_times = time_decode_attention_int8(da)
    time_decode_attention_int8_large(da)
    check_int8_products(q8)
    params = SamplingParams(**SAMPLING_2048)
    n_classes = model.config.stage2.hparams.n_classes
    labels = torch.arange(B, device='cuda') % n_classes
    scales = calibrate_int8max(model, weights, params, labels)
    int8max, bf16 = q8.INT8MAX, q8.Int8Serving()
    codes8 = run_pipelined(model, weights, params, labels, int8max, scales,
                              'int8max', da, st, q8)
    launches = since_reset('k1.int8_launches')
    codes16 = run_pipelined(model, weights, params, labels, bf16, None,
                               'bf16', da, st, q8)
    # bench.py's other int8 mode (BENCH_INT8_SPATIAL=0): float spatial gemms
    run_pipelined(model, weights, params, labels,
                  q8.Int8Serving(kv_cache=True, depth_gemms=True,
                                 decode_convs=True), scales,
                  'int8 without spatial gemms', da, st, q8, prev=codes8)
    int8max_breakdown(model, weights, params, labels, int8max, scales,
                      codes8)
    large = torch.arange(B_LARGE, device='cuda') % n_classes
    reps = B_LARGE // B
    for name, int8, sc, codes in (('int8max', int8max, scales, codes8),
                                  ('bf16', bf16, None, codes16)):
        prev = tuple(c.repeat(reps, *(1,) * (c.dim() - 1)) for c in codes)
        run_pipelined(model, weights, params, large, int8, sc, name, da, st,
                      q8, prev=prev)
    int8max_agreement(model, weights, codes16, labels, scales, q8)
    return k1_err, k1_times, launches


# --------------------------------------------------------- the encode slice

def seeded_images(n: int, res: int, seed: int, device='cuda'):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n, res, res, 3), generator=g, device=device) * 2 - 1


_COUNT_BASE = {}    # a launch counter's reading at its last reset_counts


def reset_counts(*names):
    """Start counting the launch counters `names` (`utils/tracing.py`'s
    table) from zero, for `since_reset`."""
    from hqtransformer_tpu_torch.utils import tracing
    for name in names:
        _COUNT_BASE[name] = tracing.counter(name)


def since_reset(name):
    """The launches counted under `name` since its last reset_counts."""
    from hqtransformer_tpu_torch.utils import tracing
    return tracing.counter(name) - _COUNT_BASE.get(name, 0)


def check_reconstruction(pixels, levels, n, res, grids):
    require(pixels.shape == (n, res, res, 3), f'pixel shape {pixels.shape}')
    require(bool(torch.isfinite(pixels).all()), 'pixels not finite')
    require(float(pixels.min()) >= -1.0 and float(pixels.max()) <= 1.0,
            'pixels outside [-1, 1]')
    require([tuple(c.shape) for c in levels] == [(n, s, s) for s in grids],
            f'code shapes {[tuple(c.shape) for c in levels]}')
    for c in levels:
        require(int(c.min()) >= 0 and int(c.max()) < N_CODES,
                f'codes outside [0, {N_CODES})')


def run_encode_slice(vq, da, st, stage1_weights):
    """make_reconstructor on the flagship stage-1 HQ-VAE, bf16, 128 images,
    twice; then a breakdown of one batch: encoder, quantize, decoder."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.evaluation.stage1 import (
        ReconstructionMetrics, make_reconstructor)

    cfg = build_twostage_config(str(FLAGSHIP)).stage1
    res = cfg.hparams.resolution
    images = seeded_images(B, res, seed=5)
    recon = make_reconstructor(cfg, torch.bfloat16)
    for call in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts('k3.launches', 'k1.launches', 'k2.launches')
        t0 = time.perf_counter()
        pixels, levels = recon(stage1_weights, images)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (since_reset('k3.launches'), since_reset('k1.launches'),
                    since_reset('k2.launches'))
        require(launches == (2, 0, 0), f'encode slice launches K3, K1, K2 '
                f'{launches}, expected (2, 0, 0)')
        check_reconstruction(pixels, levels, B, res, (8, 16))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'encode slice call {call}: {seconds:.3f} s, '
              f'{B / seconds:.2f} images/s at batch {B}, peak {peak:.2f} GiB, '
              f'launches K3={launches[0]}, pixels {tuple(pixels.shape)} '
              f'{pixels.dtype}')
    metrics = ReconstructionMetrics(N_CODES)
    metrics.update(images, pixels, levels)
    usage = ', '.join(f'{u:.4f}' for u in metrics.code_usage())
    print(f'encode slice (random weights): MSE {metrics.mse:.4f}, code '
          f'usage per level {usage}')
    encode_breakdown(cfg, stage1_weights, images)
    return launches[0], B / seconds


def encode_breakdown(cfg, stage1_weights, images, name=''):
    """A bf16 reconstruction split into its three phases, each run alone,
    with the K3 kernels' share of the quantize phase (the resamplers' own
    work, a product each way for 'conv2', falls in that phase too); `name`
    prefixes the phases' lines."""
    from hqtransformer_tpu_torch.models.stage1.generator import \
        build_generator

    with torch.device('meta'):
        gen = build_generator(cfg, torch.bfloat16)
    gen = gen.to_empty(device='cuda').eval()
    gen.load_state_dict(stage1_weights, strict=True, assign=True)
    x = images.permute(0, 3, 1, 2).bfloat16()

    @torch.inference_mode()
    def encoder():
        return gen.quant_conv_b(gen.encoder(x)).permute(0, 2, 3, 1)

    h_b = encoder()

    @torch.inference_mode()
    def quantize():
        quant_t, _, _ = gen.quantize_t(gen.down_t(h_b))
        quant_b, _, _ = gen._bottom_quantizer(h_b - gen.upsample_t(quant_t))
        return quant_t, quant_b

    quant = quantize()

    @torch.inference_mode()
    def decoder():
        return gen.decode(*quant)

    per_phase = profile_phases(((f'{name}encoder', encoder),
                                (f'{name}quantize (2 K3)', quantize),
                                (f'{name}decoder', decoder)))
    k3 = [(n, ms) for kname, (n, ms)
          in per_phase[f'{name}quantize (2 K3)'].items() if 'vq_' in kname]
    print(f'breakdown {name}K3 kernels in the quantize phase: '
          f'{sum(ms for _, ms in k3):.2f} ms in {sum(n for n, _ in k3)} runs')


def run_twostage_encode(vq, da, st, model, weights):
    """TwoStageModel.extract_codes and forward on the flagship two-stage
    model, bf16, batch 128."""
    res = model.config.dataset.image_resolution
    images = seeded_images(B, res, seed=6)
    labels = torch.arange(B, device='cuda') % \
        model.config.stage2.hparams.n_classes
    for name, fn in (('extract_codes',
                      lambda: model.extract_codes(weights, images)),
                     ('forward',
                      lambda: model.forward(weights, images, labels))):
        for call in (1, 2):
            torch.cuda.synchronize()
            reset_counts('k3.launches', 'k1.launches', 'k2.launches')
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = (since_reset('k3.launches'),
                        since_reset('k1.launches'),
                        since_reset('k2.launches'))
            require(launches == (2, 0, 0), f'{name} launches K3, K1, K2 '
                    f'{launches}, expected (2, 0, 0)')
        codes = out[0] if name == 'extract_codes' else out[1]
        require(tuple(codes[0].shape) == (B, 64) and
                tuple(codes[1].shape) == (B, 256),
                f'{name} code shapes {[tuple(c.shape) for c in codes]}')
        if name == 'forward':
            lt, lb = out[0]
            require(tuple(lt.shape) == (B, 64, N_CODES) and
                    tuple(lb.shape) == (B, 256, N_CODES),
                    f'logit shapes {tuple(lt.shape)}, {tuple(lb.shape)}')
            require(bool(torch.isfinite(lt).all() and
                         torch.isfinite(lb).all()), 'logits not finite')
        print(f'two-stage {name} at batch {B}: {seconds * 1e3:.1f} ms '
              f'({B / seconds:.2f} images/s), launches K3={launches[0]}')


# ------------------------------------------------------ 3-level sampling

LEVEL3_S2 = ROOT / 'configs/imagenet/stage2/hqtransformer-l12-top8x8-level3.yaml'
LEVEL3_KNOBS = dict(top_k=(K2_LEVEL3_K,) * 3,
                    temperature=(K2_LEVEL3_TEMP,) * 3)
TOP4X4_S2 = (ROOT / 'configs/imagenet/stage2/'
             'hqtransformer-l12-top4x4-level3.yaml')
# The JAX package calibrates the 3-level stage 2 on 32 samples: its
# teacher-forced logits are [B, 21 x 64, 8192].
N_CALIB_STAGE2 = 32
B_LEVEL3_LARGE = 256     # the JAX bench family's l12-level3-int8max batch


def level3_model(config_path):
    """A 3-level TwoStageModel at full width in bf16 with seeded random
    bf16 serving weights, and its labels at batch B."""
    return bf16_model(config_path, lambda cfg: torch.arange(B) %
                      cfg.stage2.hparams.n_classes)


def run_level3_sampling(da, st, q8):
    """Phase 8: the 3-level family at full width: the flagship level-3
    config (12 layers, d 1536, three 8192-code levels, parallel-add) with
    seeded random bf16 weights, make_pixel_sampler_multilevel at top-k 2048
    and T 1.0 a level on 128 labels: two calls, then one with bisect3,
    each checked by `checked_call`. Then the AR loop and the stage-1 decode
    broken down. Returns (K2 bisect3 launches of the third call,
    samples/s of the second, the model, its weights, the first call's
    codes)."""
    model, weights, labels = level3_model(LEVEL3_S2)
    require((model.code_levels, model.top_res) == (3, 8),
            f'3-level grid {model.code_levels} levels, top '
            f'{model.top_res}x{model.top_res}')
    gen = torch.Generator(device='cuda').manual_seed(1)
    out = []
    for call, bisect3 in ((1, False), (2, False), (3, True)):
        sampler = model.make_pixel_sampler_multilevel(bisect3=bisect3,
                                                      **LEVEL3_KNOBS)
        out.append(sampler_call(model, weights, sampler, gen, labels,
                                f'3-level sampling call {call} (bisect3 '
                                f'{bisect3})', da, st, q8, bisect3=bisect3))
    k2b_launches = since_reset('k2.bisect3_launches')
    level3_breakdown(model, weights, labels, gen, '3-level')
    return k2b_launches, out[1][1], model, weights, out[0][0]


def level3_breakdown(model, weights, labels, gen, name, int8=None,
                     scales=None):
    """The 3-level batch's AR loop (make_multilevel_sampler) and stage-1
    decode, each timed alone and profiled (as phase 3's breakdown); in
    int8max with `int8` and `scales`."""
    from hqtransformer_tpu_torch.models.stage2.multilevel import \
        cells_to_level
    from hqtransformer_tpu_torch.ops.int8 import Int8Serving
    from hqtransformer_tpu_torch.sampling.engine import (
        LevelSampling, make_multilevel_sampler)

    int8 = int8 or Int8Serving()
    model.load_weights(weights)
    n = model.top_res
    sampler = make_multilevel_sampler(model.stage2, n * n, tuple(
        LevelSampling(top_k=k, temperature=t)
        for k, t in zip(LEVEL3_KNOBS['top_k'],
                        LEVEL3_KNOBS['temperature'])), int8, scales)
    tops, mids, bots = sampler(gen, labels)
    maps = [tops.reshape(-1, n, n)] + [
        cells_to_level(c, n, w).reshape(-1, n * w, n * w)
        for c, w in ((mids, 2), (bots, 4))]

    @torch.inference_mode()
    def decode():
        if not int8.decode_convs:
            return model.stage1.decode_code(maps)
        with model.stage1.int8_decode(scales['stage1/act_scales']):
            return model.stage1.decode_code(maps)

    decode_name = 'int8 stage-1 decode' if int8.decode_convs else \
        'stage-1 decode'
    profile_phases(((f'{name} AR loop', lambda: sampler(gen, labels)),
                    (f'{name} {decode_name}', decode)))


def calibrate_level3(model, weights, labels, path):
    """The three calibrations of a 3-level model, as the JAX package's
    measure_throughput.py runs them for int8max: KV scales from one bf16
    sampling run on `labels` (top-k 2048, T 1.0), decode scales from
    decode_code on the same draw's three maps (one generator seed), stage-2
    scales from the teacher-forced forward on its first 32 samples; saved
    to `path` and loaded back bit for bit. Returns the loaded scales."""
    from hqtransformer_tpu_torch.models.stage2.multilevel import \
        cells_to_level
    from hqtransformer_tpu_torch.models.twostage import (load_serving_scales,
                                                         save_serving_scales)
    from hqtransformer_tpu_torch.sampling.engine import (
        LevelSampling, make_multilevel_sampler)

    n, nb = model.top_res, labels.shape[0]
    levels = tuple(LevelSampling(top_k=k, temperature=t)
                   for k, t in zip(LEVEL3_KNOBS['top_k'],
                                   LEVEL3_KNOBS['temperature']))
    t0 = time.perf_counter()
    scales = model.calibrate_kv_scales(
        weights, torch.Generator(device='cuda').manual_seed(7), labels,
        levels)
    codes = make_multilevel_sampler(model.stage2, n * n, levels)(
        torch.Generator(device='cuda').manual_seed(7), labels)
    rasters = [codes[0]] + [cells_to_level(c, n, w).reshape(nb, -1)
                            for c, w in ((codes[1], 2), (codes[2], 4))]
    scales.update(model.calibrate_int8_decode(weights, [
        r.reshape(nb, n * w, n * w) for r, w in zip(rasters, (1, 2, 4))]))
    scales.update(model.calibrate_stage2_int8(
        weights, [r[:N_CALIB_STAGE2] for r in rasters],
        labels[:N_CALIB_STAGE2]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    save_serving_scales(scales, str(path))
    loaded = load_serving_scales(str(path))
    require(sorted(loaded) == sorted(scales) and all(
        sorted(loaded[k]) == sorted(scales[k]) and all(
            torch.equal(loaded[k][m], scales[k][m].cpu()) for m in scales[k])
        for k in scales), f'{path.name}: scales changed through the artifact')
    counts = ', '.join(f'{k} {len(v)}' for k, v in sorted(loaded.items()))
    print(f'3-level calibration at batch {nb} (stage 2 on '
          f'{N_CALIB_STAGE2}): {seconds:.2f} s ({counts} scales), saved to '
          f'{path.relative_to(ROOT)} and loaded back bit for bit')
    return loaded


def run_level3_int8max(da, st, q8, model, weights, bf16_codes):
    """Phase 9: int8max serving of the 3-level family on phase 8's model
    and weights: calibration (`calibrate_level3`), two int8max calls of
    make_pixel_sampler_multilevel at batch 128 (the first on phase 8's
    first generator seed, its codes' per-level agreement with phase 8's
    bf16 codes printed: random weights, a number to record), the int8max
    AR loop and int8 decode broken down, and one call at batch 256."""
    t0 = time.perf_counter()
    labels = torch.arange(B, device='cuda') % \
        model.config.stage2.hparams.n_classes
    scales = calibrate_level3(model, weights, labels, LEVEL3_SCALES_PATH)
    sampler = model.make_pixel_sampler_multilevel(
        int8=q8.INT8MAX, scales=scales, **LEVEL3_KNOBS)
    gen = torch.Generator(device='cuda').manual_seed(1)
    for call in (1, 2):
        codes, _ = sampler_call(model, weights, sampler, gen, labels,
                                f'3-level int8max call {call}', da, st, q8,
                                int8=True)
        if call == 1:
            agree = [float((a == b).float().mean())
                     for a, b in zip(codes, bf16_codes)]
            print(f'3-level int8max codes equal to bf16 on the same '
                  f'generator seed: top {agree[0]:.4f}, mid {agree[1]:.4f}, '
                  f'bottom {agree[2]:.4f} (random weights)')
    level3_breakdown(model, weights, labels, gen, '3-level int8max',
                     q8.INT8MAX, scales)
    large = torch.arange(B_LEVEL3_LARGE, device='cuda') % \
        model.config.stage2.hparams.n_classes
    sampler_call(model, weights, sampler, gen, large,
                 f'3-level int8max at batch {B_LEVEL3_LARGE}', da, st, q8,
                 int8=True)
    print(f'phase 9 (3-level int8max): {time.perf_counter() - t0:.1f} s')


def run_top4x4(da, st, q8):
    """The 4x4-top level-3 config (stage-1 ch_mult [1, 2, 4, 4], a 16x16
    latent; 4x4 / 8x8 / 16x16 codes over 16 spatial steps) at full width
    with seeded random bf16 weights: two bf16 calls of
    make_pixel_sampler_multilevel (top-k 2048, T 1.0) at batch 128, then
    calibration as phase 9 and one int8max call, each checked by
    `checked_call` (12 x 15 K1 and 48 K2 launches a call)."""
    t0 = time.perf_counter()
    model, weights, labels = level3_model(TOP4X4_S2)
    require((model.code_levels, model.top_res) == (3, 4),
            f'4x4-top grid {model.code_levels} levels, top '
            f'{model.top_res}x{model.top_res}')
    sampler = model.make_pixel_sampler_multilevel(**LEVEL3_KNOBS)
    gen = torch.Generator(device='cuda').manual_seed(1)
    for call in (1, 2):
        sampler_call(model, weights, sampler, gen, labels,
                     f'4x4-top bf16 call {call}', da, st, q8)
    scales = calibrate_level3(model, weights, labels, TOP4X4_SCALES_PATH)
    sampler = model.make_pixel_sampler_multilevel(
        int8=q8.INT8MAX, scales=scales, **LEVEL3_KNOBS)
    sampler_call(model, weights, sampler, gen, labels,
                 '4x4-top int8max call', da, st, q8, int8=True)
    print(f'4x4-top config: {time.perf_counter() - t0:.1f} s')


def level3_tiny_config():
    """The flagship level-3 config cut to a tiny size, as the CPU tests
    build it but at d 128 (head dim 32, the least K1 takes): 2 spatial
    layers, 4 heads, a 4x4 top, vocabularies (32, 48, 64), the 3-level
    HQ-VAE at 64^2."""
    from hqtransformer_tpu_torch.config import build_twostage_config

    cfg = build_twostage_config(str(LEVEL3_S2))
    cfg.dataset.image_resolution = 64
    s1, s2 = cfg.stage1, cfg.stage2
    s1.hparams.resolution, s1.hparams.ch, s1.hparams.ch_mult = 64, 32, [1, 2]
    s1.hparams.z_channels, s1.hparams.attn_resolutions = 64, [16]
    s1.embed_dim, s1.n_embed, s1.n_embed_levels = 64, 64, [32, 48, 64]
    s2.vocab_sizes_img, s2.vocab_size_img = [32, 48, 64], 64
    hp = s2.hparams
    hp.embed_dim, hp.n_layers, hp.n_heads = 128, 2, 4
    hp.n_classes, hp.ctx_len_img = 10, 16
    return cfg


def check_level3_reference(st):
    """Tiny 3-level config, f32, greedy (top-k 1 at every level, and once
    with bisect3): the CUDA path's codes equal the CPU plain path's with
    the same weights, pixels within 1e-3."""
    from hqtransformer_tpu_torch.models.twostage import TwoStageModel

    cfg = level3_tiny_config()
    labels = torch.arange(8) % cfg.stage2.hparams.n_classes
    cpu = TwoStageModel(cfg, device='cpu')
    weights = cpu.init_weights(seed=4)
    gpu = TwoStageModel(cfg, device='cuda')
    w_gpu = {s: {k: v.cuda() for k, v in w.items()}
             for s, w in weights.items()}
    for bisect3 in (False, True):
        knobs = dict(top_k=(1, 1, 1), bisect3=bisect3)
        ref_px, ref = cpu.make_pixel_sampler_multilevel(**knobs)(
            weights, torch.Generator().manual_seed(0), labels)
        reset_counts('k2.launches')
        px, codes = gpu.make_pixel_sampler_multilevel(**knobs)(
            w_gpu, torch.Generator(device='cuda').manual_seed(0),
            labels.cuda())
        torch.cuda.synchronize()
        k2 = since_reset('k2.launches')
        require(k2 == 3 * 16,
                f'tiny 3-level sampler launched K2 {k2} times')
        require(all(torch.equal(c.cpu(), r) for c, r in zip(codes, ref)),
                f'tiny 3-level greedy codes differ between the CUDA and the '
                f'CPU path (bisect3 {bisect3})')
        err = (px.cpu() - ref_px).abs().max().item()
        require(err <= 1e-3, f'tiny 3-level greedy pixels differ by {err}')
        print(f'tiny 3-level greedy reference (bisect3 {bisect3}): codes '
              f'equal to the CPU plain path, max|pixels - cpu| = {err:.2e}')


def check_top2mid2bot_reference():
    """The tiny level-3 config with 'top2mid2bot' (the fully causal depth,
    which has a teacher-forced forward and no sampler), f32: its
    teacher-forced logits on the card equal the CPU's within 1e-4."""
    from hqtransformer_tpu_torch.models.twostage import (build_stage2,
                                                         random_state)

    cfg = level3_tiny_config()
    cfg.stage2.decoding_type = 'top2mid2bot'
    cpu = build_stage2(cfg).eval()
    state = random_state(cpu, torch.Generator().manual_seed(5))
    cpu.load_state_dict(state)
    gpu = build_stage2(cfg).cuda().eval()
    gpu.load_state_dict(state)
    g = torch.Generator().manual_seed(6)
    codes = [torch.randint(0, v, (8, 16 * 4 ** li), generator=g)
             for li, v in enumerate(cfg.stage2.vocab_sizes_img)]
    labels = torch.arange(8) % cfg.stage2.hparams.n_classes
    with torch.inference_mode():
        ref = cpu(codes, labels)
        out = gpu([c.cuda() for c in codes], labels.cuda())
    err = max((o.cpu() - r).abs().max().item() for o, r in zip(out, ref))
    require(err <= 1e-4, f'tiny top2mid2bot logits differ by {err}')
    print(f'tiny top2mid2bot teacher-forced logits: max|card - cpu| = '
          f'{err:.2e} over {[tuple(o.shape) for o in out]}')


def run_level3(vq, da, st):
    """make_reconstructor on the 3-level HQ-VAE at batch 32, bf16."""
    from hqtransformer_tpu_torch.config import build_stage1_config
    from hqtransformer_tpu_torch.evaluation.stage1 import (
        init_stage1_weights, make_reconstructor)
    from hqtransformer_tpu_torch.models.twostage import serving_bf16_params

    cfg = build_stage1_config(str(LEVEL3)).stage1
    res = cfg.hparams.resolution
    weights = serving_bf16_params(init_stage1_weights(cfg, seed=3))
    images = seeded_images(B_LEVEL3, res, seed=7)
    recon = make_reconstructor(cfg, torch.bfloat16)
    for call in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts('k3.launches', 'k1.launches', 'k2.launches')
        t0 = time.perf_counter()
        pixels, levels = recon(weights, images)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (since_reset('k3.launches'), since_reset('k1.launches'),
                    since_reset('k2.launches'))
        require(launches == (3, 0, 0), f'3-level launches K3, K1, K2 '
                f'{launches}, expected (3, 0, 0)')
        check_reconstruction(pixels, levels, B_LEVEL3, res, (8, 16, 32))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'3-level reconstruction call {call}: {seconds:.3f} s, '
              f'{B_LEVEL3 / seconds:.2f} images/s at batch {B_LEVEL3}, peak '
              f'{peak:.2f} GiB, launches K3={launches[0]}')


def run_encode_f32(vq, da, st):
    """make_reconstructor on the flagship stage-1 HQ-VAE at its default
    f32, as eval_stage1.py runs it (seeded random f32 weights, TF32 off),
    128 images, twice: 2 K3 launches a call, each on the f32 x f32 route.
    Returns the second call's K3 launches and images/s."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.evaluation.stage1 import (
        init_stage1_weights, make_reconstructor)

    cfg = build_twostage_config(str(FLAGSHIP)).stage1
    res = cfg.hparams.resolution
    weights = init_stage1_weights(cfg, seed=4)
    images = seeded_images(B, res, seed=8)
    recon = make_reconstructor(cfg)
    for call in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts('k3.launches', 'k1.launches', 'k2.launches')
        t0 = time.perf_counter()
        pixels, levels = recon(weights, images)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (since_reset('k3.launches'), since_reset('k1.launches'),
                    since_reset('k2.launches'))
        require(launches == (2, 0, 0), f'f32 encode launches K3, K1, K2 '
                f'{launches}, expected (2, 0, 0)')
        check_reconstruction(pixels, levels, B, res, (8, 16))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'f32 encode slice call {call}: {seconds:.3f} s, '
              f'{B / seconds:.2f} images/s at batch {B}, peak {peak:.2f} GiB, '
              f'launches K3={launches[0]} '
              f'({pair_list(vq, torch.float32, torch.float32)}), '
              f'pixels {tuple(pixels.shape)} {pixels.dtype}')
    return launches[0], B / seconds


def check_small_reference(vq):
    """Tiny config, f32: greedy sampling, code extraction and
    reconstruction through the CUDA kernels against the CPU plain path with
    the same weights and inputs."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.evaluation.stage1 import make_reconstructor
    from hqtransformer_tpu_torch.models.twostage import TwoStageModel
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    cfg = build_twostage_config(str(TINY))
    greedy = SamplingParams(top_k_top=1, top_k_bot=1)
    labels = torch.arange(8) % cfg.stage2.hparams.n_classes
    cpu = TwoStageModel(cfg, device='cpu')
    weights = cpu.init_weights(seed=2)
    ref_px, (ref_t, ref_b) = cpu.make_pixel_sampler(params=greedy)(
        weights, torch.Generator().manual_seed(0), labels)
    gpu = TwoStageModel(cfg, device='cuda')
    w_gpu = {s: {k: v.cuda() for k, v in w.items()}
             for s, w in weights.items()}
    px, (ct, cb) = gpu.make_pixel_sampler(params=greedy)(
        w_gpu, torch.Generator(device='cuda').manual_seed(0), labels.cuda())
    require(torch.equal(ct.cpu(), ref_t) and torch.equal(cb.cpu(), ref_b),
            'tiny greedy codes differ between the CUDA and the CPU path')
    err = (px.cpu() - ref_px).abs().max().item()
    require(err <= 1e-3, f'tiny greedy pixels differ by {err}')
    print(f'tiny greedy reference: codes equal to the CPU plain path, '
          f'max|pixels - cpu| = {err:.2e}')

    res = cfg.dataset.image_resolution
    images = seeded_images(8, res, seed=9, device='cpu')
    (ref_t, ref_b), _ = cpu.extract_codes(weights, images)
    reset_counts('k3.launches')
    (ct, cb), _ = gpu.extract_codes(w_gpu, images.cuda())
    torch.cuda.synchronize()
    require(since_reset('k3.launches') == 2,
            'tiny extract_codes did not run K3')
    require(torch.equal(ct.cpu(), ref_t) and torch.equal(cb.cpu(), ref_b),
            'tiny extract_codes differ between the CUDA and the CPU path')
    ref_px, ref_levels = make_reconstructor(cfg.stage1, device='cpu')(
        weights['stage1'], images)
    px, levels = make_reconstructor(cfg.stage1, device='cuda')(
        w_gpu['stage1'], images.cuda())
    require(all(torch.equal(a.cpu(), b) for a, b in zip(levels, ref_levels)),
            'tiny reconstruction codes differ between CUDA and CPU')
    err = (px.cpu() - ref_px).abs().max().item()
    require(err <= 1e-3, f'tiny reconstruction pixels differ by {err}')
    print(f'tiny encode reference: extract_codes and reconstruction codes '
          f'equal to the CPU plain path, max|pixels - cpu| = {err:.2e}')


# ------------------------------------- phase 10: the other conditionings

FFHQ_S2 = ROOT / 'configs/ffhq/stage2/hqtransformer-l24-ffhq.yaml'
CC15M_S2 = ROOT / 'configs/cc15m/stage2/hqtransformer-l12-cc15m.yaml'
TXT_SCALES_PATH = ROOT / 'build' / 'int8max_txt_scales.pkl'
# K1 on the text path: 12 layers over a 64-token caption and 64 image
# positions, T = 64 + 64 - 1 cache rows, the steps at pos 64..126 (past
# both kernels' first 64-row round); on FFHQ l24: 24 layers at d 1024, 16
# heads (hd 64), T = 64.
N_TXT = 64
T_TXT = N_TXT + 64 - 1
TXT_POSITIONS = range(N_TXT, T_TXT)
D_FFHQ, NH_FFHQ = 1024, 16
# (layers, rows, batch, d, heads, caches, positions, layer); layer None
# is pos % layers. Batch 1024 as phase 10's large calls run K1; the
# 12-layer text cache at batch 1024 holds 2.4e9 elements, and its layer
# 11 lies past 2^31 of them.
K1_TXT_CASES = (
    (2, T_TXT, B, D, NH, ('bf16', 'int8'), (63, 64, 65, 95, 126), None),
    (2, T, B, D_FFHQ, NH_FFHQ, ('bf16',), (0, 33, 63), None),
    (2, T_TXT, B_LARGE, D, NH, ('bf16',), (64, 95), None),
    (12, T_TXT, B_LARGE, D, NH, ('bf16',), (64, 126), 11),
    (2, T, B_LARGE, D_FFHQ, NH_FFHQ, ('bf16',), (33, 63), None))
# The text sweep's caches rotate over this many layers, so that no timed
# call finds its rows in L2 from an earlier one (one layer's bf16 cache at
# T 127 is 50 MB).
TXT_SWEEP_LAYERS = 60
# 128 captions: every combination of these subjects, looks and scenes.
SUBJECTS = ('a red fox', 'two old sailboats', 'a bowl of ramen',
            'a snowy mountain cabin')
LOOKS = ('in watercolor', 'photographed at dusk', 'as a pencil sketch',
         'under neon lights')
SCENES = ('on a quiet street', 'beside a lake', 'in a busy market',
          'at the edge of a forest', 'during heavy rain', 'on a sunny beach',
          'inside a glass greenhouse', 'above the clouds')
CAPTIONS = [f'{s.capitalize()} {look}, {scene}.' for s in SUBJECTS
            for look in LOOKS for scene in SCENES]


def k1_case(da, cache, n_layers, n_rows, batch, d, n_heads, pos, layer,
            seed):
    """K1 on one case, bf16 q, at `layer` of the cache, against its plain
    version: caches bit-equal; returns max |y - plain| (in units of 1/127
    on an int8 cache, as `check_decode_attention_int8` reads it)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    shape = (n_layers, n_rows, batch, d)
    if cache == 'int8':
        kc, vc = (torch.randint(-128, 128, shape, generator=g, device='cuda',
                                dtype=torch.int8) for _ in range(2))
        kn, vn = (torch.randint(-128, 128, (batch, d), generator=g,
                                device='cuda', dtype=torch.int8)
                  for _ in range(2))
        q = (torch.randn((batch, d), generator=g, device='cuda') *
             0.02).bfloat16()
    else:
        kc, vc = (torch.randn(shape, generator=g, device='cuda',
                              dtype=torch.bfloat16) for _ in range(2))
        q, kn, vn = (torch.randn((batch, d), generator=g,
                                 device='cuda').bfloat16() for _ in range(3))
    kc1, vc1 = kc.clone(), vc.clone()
    y1 = da.decode_attention_step(q, kn, vn, kc1, vc1, layer, pos, n_heads)
    y2 = da.decode_attention_step_plain(q, kn, vn, kc, vc, layer, pos,
                                        n_heads)
    torch.cuda.synchronize()
    require(torch.equal(kc1, kc) and torch.equal(vc1, vc),
            f'K1 {cache} cache rows differ (L {n_layers} T {n_rows} B '
            f'{batch} d {d}, layer {layer} pos {pos})')
    scale = 127 if cache == 'int8' else 1
    y1, y2 = y1.float() / scale, y2.float() / scale
    torch.testing.assert_close(y1, y2, atol=2e-2, rtol=2e-2)
    return (y1 - y2).abs().max().item()


def check_k1_conditioned(da):
    """K1 against its plain version at the shapes of phase 10's paths
    (K1_TXT_CASES): the text path's 127-row cache at pos 63..126 (bf16 and
    int8 caches), FFHQ's d 1024 with 16 heads (bf16), both at batch 128
    and 1024."""
    for (n_layers, n_rows, batch, d, n_heads, caches, positions,
         layer) in K1_TXT_CASES:
        for cache in caches:
            for pos in positions:
                at = pos % n_layers if layer is None else layer
                err = k1_case(da, cache, n_layers, n_rows, batch, d,
                              n_heads, pos, at, seed=pos + d)
                unit = ' / 127' if cache == 'int8' else ''
                print(f'K1 {cache} cache, bf16 q, L={n_layers} T={n_rows} '
                      f'B={batch} d={d} heads={n_heads} layer={at} '
                      f'pos={pos:3d}: caches bit-equal, max|y - plain|{unit} '
                      f'= {err:.3e} (tol 2e-2)')
        torch.cuda.empty_cache()


def time_k1_conditioned(da):
    """K1 at pos 95 and 126 on the text path's cache (T 127, B 128, d 1536,
    bf16 and int8) and at pos 33 on FFHQ's (d 1024, 16 heads), each beside
    its bound; then every text position 64..126 on both caches, summed
    over a text batch's 756 launches beside the summed bound."""
    g = torch.Generator(device='cuda').manual_seed(21)
    q = (torch.randn((B, D), generator=g, device='cuda') * 0.02).bfloat16()
    shape = (TXT_SWEEP_LAYERS, T_TXT, B, D)
    kc8, vc8 = (torch.randint(-128, 128, shape, generator=g, device='cuda',
                              dtype=torch.int8) for _ in range(2))
    kn8, vn8 = (torch.randint(-128, 128, (B, D), generator=g, device='cuda',
                              dtype=torch.int8) for _ in range(2))
    operands = {'int8': (kn8, vn8, kc8, vc8),
                'bf16': tuple(x.bfloat16() for x in (kn8, vn8, kc8, vc8))}
    times = {cache: {} for cache in operands}
    for pos in TXT_POSITIONS:
        for cache, (kn, vn, kc, vc) in operands.items():
            times[cache][pos] = time_ms(lambda i: da.decode_attention_step(
                q, kn, vn, kc, vc, i % TXT_SWEEP_LAYERS, pos, NH), 120)
    for pos in (95, 126):
        for cache in operands:
            ms = times[cache][pos]
            bnd = bound(k1_bytes(pos, B, cache == 'int8'),
                        k1_flops(pos, B))
            print(f'K1 {cache} cache, bf16 q, T {T_TXT} pos {pos} B {B}: '
                  f'kernel {ms:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}; '
                  f'kernel {ms / bnd[0]:.2f}x)')
    for cache in operands:
        ts = [times[cache][p] for p in TXT_POSITIONS]
        a, slope = fit_line(list(TXT_POSITIONS), ts)
        total = L * sum(ts)
        bound_sum = L * sum(bound(k1_bytes(p, B, cache == 'int8'),
                                  k1_flops(p, B))[0] for p in TXT_POSITIONS)
        print(f'K1 text sweep {cache} caches, B {B}, pos 64..126: time = '
              f'{a * 1e3:.3f} us + {slope * 1e3:.4f} us x pos; a text '
              f'batch\'s {len(ts) * L} launches sum to {total:.4f} ms '
              f'against a summed bound of {bound_sum:.4f} ms '
              f'({bound_sum / total:.1%})')
    del operands, kc8, vc8
    n_layers, pos = 24, 33
    kc, vc = (torch.randn((n_layers, T, B, D_FFHQ), generator=g,
                          device='cuda').bfloat16() for _ in range(2))
    qf, kn, vn = (torch.randn((B, D_FFHQ), generator=g,
                              device='cuda').bfloat16() for _ in range(3))
    ms = time_ms(lambda i: da.decode_attention_step(
        qf, kn, vn, kc, vc, i % n_layers, pos, NH_FFHQ), 240)
    bnd = bound(k1_bytes(pos, B, False, D_FFHQ),
                k1_flops(pos, B, D_FFHQ))
    print(f'K1 bf16 cache, d {D_FFHQ} {NH_FFHQ} heads, pos {pos} B {B}: '
          f'kernel {ms:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}; kernel '
          f'{ms / bnd[0]:.2f}x); FFHQ\'s 1,512 launches a batch at about '
          f'{ms * 24 * 63:.2f} ms')
    del kc, vc
    torch.cuda.empty_cache()


def run_ffhq(da, st, q8):
    """FFHQ l24 as released (unconditional, `reduce`, 24 layers, d 1024):
    make_pixel_sampler at top-k 2048, T 0.95 on 128 dummy labels, twice,
    then a breakdown, then one call at batch 1024."""
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    model, weights, labels = bf16_model(
        FFHQ_S2, lambda cfg: torch.zeros(B, dtype=torch.long))
    require((model.stage2.use_cls_cond, model.stage2.use_txt_cond,
             model.stage2.emb.kind, model.top_res) ==
            (False, False, 'reduce', 8), 'FFHQ l24 is not the unconditional '
            '"reduce" model of an 8x8 top')
    params = SamplingParams(**SAMPLING_2048)
    sampler = model.make_pixel_sampler(params=params)
    gen = torch.Generator(device='cuda').manual_seed(1)
    for call in (1, 2):
        sampler_call(model, weights, sampler, gen, labels,
                     f'FFHQ l24 bf16 call {call}', da, st, q8)
    breakdown(model, weights, params, labels, gen, 'FFHQ l24 ')
    sampler_call(model, weights, sampler, gen,
                 torch.zeros(B_LARGE, dtype=torch.long, device='cuda'),
                 f'FFHQ l24 bf16 at batch {B_LARGE}', da, st, q8)
    del model, weights
    torch.cuda.empty_cache()


def caption_ids(n_txt):
    """CAPTIONS through the port's BPE-16k tokenizer: [128, n_txt] ids."""
    from hqtransformer_tpu_torch.data.tokenizers import tokenize
    return torch.tensor(tokenize(CAPTIONS, n_txt), dtype=torch.long)


def calibrate_txt(model, weights, tokens, params):
    """int8max scales of the text model as measure_throughput.py takes
    them: KV scales from one bf16 sampling run, decode scales on the codes
    of a bf16 pixel-sampler call, stage-2 scales on its first 64 samples;
    saved to build/int8max_txt_scales.pkl and loaded back bit for bit."""
    from hqtransformer_tpu_torch.models.stage2.hierarchical import \
        cells_to_raster
    from hqtransformer_tpu_torch.models.twostage import (load_serving_scales,
                                                         save_serving_scales)

    t0 = time.perf_counter()
    scales = model.calibrate_kv_scales(
        weights, torch.Generator(device='cuda').manual_seed(2), tokens)
    _, (ct, cb) = model.make_pixel_sampler(params=params)(
        weights, torch.Generator(device='cuda').manual_seed(3), tokens)
    tr, win = model.top_res, model.cell_win
    raster = cells_to_raster(cb, tr, win)
    scales.update(model.calibrate_int8_decode(
        weights, ct.reshape(-1, tr, tr),
        raster.reshape(-1, tr * win, tr * win)))
    n = min(64, ct.shape[0])
    scales.update(model.calibrate_stage2_int8(
        weights, ct[:n], raster.reshape(ct.shape[0], -1)[:n], tokens[:n]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    TXT_SCALES_PATH.parent.mkdir(parents=True, exist_ok=True)
    save_serving_scales(scales, str(TXT_SCALES_PATH))
    loaded = load_serving_scales(str(TXT_SCALES_PATH))
    require(sorted(loaded) == sorted(scales) and all(
        torch.equal(loaded[k][n], scales[k][n].cpu())
        for k in scales for n in scales[k]),
        'text serving scales changed through the artifact')
    require('head_txt' not in loaded['stage2/act_scales'],
            'head_txt got an int8 scale')
    counts = ', '.join(f'{k} {len(v)}' for k, v in sorted(loaded.items()))
    print(f'CC15M int8max calibration at batch {tokens.shape[0]}: '
          f'{seconds:.2f} s ({counts} scales), saved to '
          f'{TXT_SCALES_PATH.relative_to(ROOT)} and loaded back bit for bit')
    return loaded


def run_cc15m(da, st, q8):
    """CC15M l12 text-to-image as released: 128 captions tokenized by the
    port's tokenizer, make_pixel_sampler at top-k 2048, T 0.95, twice in
    bf16, a breakdown, one call at batch 1024; then int8max calibrated as
    measure_throughput.py does and one int8max call at batch 128 on the
    first bf16 call's generator seed, with the per-level code agreement."""
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    model, weights, tokens = bf16_model(
        CC15M_S2, lambda cfg: caption_ids(cfg.stage2.hparams.ctx_len_txt))
    require(model.stage2.use_txt_cond and model.stage2.sos_len == N_TXT and
            tuple(tokens.shape) == (B, N_TXT), 'CC15M is not the text model '
            f'of a 64-token caption ({tuple(tokens.shape)})')
    require(bool((tokens > 0).sum(1).min() > 0) and bool(
        (tokens < model.config.stage2.vocab_size_txt).all()),
        'caption ids out of range or empty')
    params = SamplingParams(**SAMPLING_2048)
    sampler = model.make_pixel_sampler(params=params)
    seed = 1
    gen = torch.Generator(device='cuda').manual_seed(seed)
    codes16, _ = sampler_call(model, weights, sampler, gen, tokens,
                              'CC15M text bf16 call 1', da, st, q8)
    sampler_call(model, weights, sampler, gen, tokens,
                 'CC15M text bf16 call 2', da, st, q8)
    breakdown(model, weights, params, tokens, gen, 'CC15M text ')
    sampler_call(model, weights, sampler, gen,
                 tokens.repeat(B_LARGE // B, 1),
                 f'CC15M text bf16 at batch {B_LARGE}', da, st, q8)
    scales = calibrate_txt(model, weights, tokens, params)
    sampler8 = model.make_pixel_sampler(params=params, int8=q8.INT8MAX,
                                        scales=scales)
    codes8, _ = sampler_call(
        model, weights, sampler8,
        torch.Generator(device='cuda').manual_seed(seed), tokens,
        'CC15M text int8max call', da, st, q8, int8=True)
    agree = [float((a == b).float().mean()) for a, b in zip(codes8, codes16)]
    print(f'CC15M int8max vs bf16 codes on one generator seed (random '
          f'weights): top {agree[0]:.2%}, bottom {agree[1]:.2%}')
    del model, weights
    torch.cuda.empty_cache()


def run_conditioned(da, st, q8):
    """Phase 10: K1 at the new paths' shapes, FFHQ l24 and CC15M text."""
    t0 = time.perf_counter()
    check_k1_conditioned(da)
    time_k1_conditioned(da)
    run_ffhq(da, st, q8)
    run_cc15m(da, st, q8)
    print(f'phase 10 (the other conditionings): '
          f'{time.perf_counter() - t0:.1f} s')


# ------------------------------------------ phase 11: the other samplers

IMAGENET_S2 = ROOT / 'configs/imagenet/stage2'
BIDIR_S2 = IMAGENET_S2 / 'hqtransformer-l12-top8x8-bidirectional.yaml'
CAUSAL_S2 = IMAGENET_S2 / 'hqtransformer-l12-top8x8-causal.yaml'
IGPT_S2 = IMAGENET_S2 / 'vqvae2-l12-top8x8.yaml'
TXT2IMG_S2 = IMAGENET_S2 / 'vqvae2-l4-cond-top8x8-pred-bot16x16.yaml'
# Transformer1d's cache: a 64-token prefix (the top codes) and 256 bottom
# codes, T = 64 + 256 - 1 rows, the steps at pos 64..318 (five of K1's
# 64-row rounds at pos 318).
N_FLAT_TXT, N_FLAT_IMG = 64, 256
T_FLAT = N_FLAT_TXT + N_FLAT_IMG - 1
FLAT_POSITIONS = (64, 191, 318)
# The bidirectional depth mode draws the top and its 4 bottoms at once.
K2_JOINT_ROWS = 5 * B
# The top-p cell: the flagship at its top-k and temperature, p 0.95.
SAMPLING_TOP_P = dict(SAMPLING_2048, top_p_top=0.95, top_p_bot=0.95)
# Bytes of cache the K1 timings rotate over, so that no timed call finds
# its rows in L2 (50 MB) from an earlier one.
K1_ROTATE_BYTES = 400 * 2**20


def check_k1_flat(da):
    """K1 against its plain version on Transformer1d's cache (T 319, d 1536,
    24 heads, bf16) at pos 64, 191 and 318, at batch 128 and 1024: caches
    bit-equal, y within 2e-2 (`k1_case`). Returns the largest |y - plain|."""
    err = 0.0
    for batch in (B, B_LARGE):
        for pos in FLAT_POSITIONS:
            e = k1_case(da, 'bf16', 2, T_FLAT, batch, D, NH, pos, pos % 2,
                        seed=pos + batch)
            err = max(err, e)
            print(f'K1 bf16 cache, L=2 T={T_FLAT} B={batch} d={D} '
                  f'layer={pos % 2} pos={pos:3d}: caches bit-equal, '
                  f'max|y - plain| = {e:.3e} (tol 2e-2)')
        torch.cuda.empty_cache()
    return err


def time_k1_shape(da, n_rows, d, n_heads, pos, label):
    """K1 at one cache shape and position (bf16, batch 128) beside its
    plain version, SDPA over the valid rows (pre-permuted to
    [B, heads, pos + 1, hd] outside the timed region) and its bound; the
    calls rotate over enough layers to hold K1_ROTATE_BYTES. Returns
    (kernel, plain, library, bound)."""
    hd = d // n_heads
    layer_bytes = 2 * (pos + 1) * B * d * 2
    n_layers = max(4, -(-K1_ROTATE_BYTES // layer_bytes))
    g = torch.Generator(device='cuda').manual_seed(pos + d)
    kc, vc = (torch.randn((n_layers, n_rows, B, d), generator=g,
                          device='cuda').bfloat16() for _ in range(2))
    q, kn, vn = (torch.randn((B, d), generator=g, device='cuda').bfloat16()
                 for _ in range(3))
    kernel = time_ms(lambda i: da.decode_attention_step(
        q, kn, vn, kc, vc, i % n_layers, pos, n_heads), 240)
    plain = time_ms(lambda i: da.decode_attention_step_plain(
        q, kn, vn, kc, vc, i % n_layers, pos, n_heads), 24)

    def heads(c, layer):
        return c[layer, :pos + 1].reshape(pos + 1, B, n_heads, hd).permute(
            1, 2, 0, 3).contiguous()
    ks = [heads(kc, layer) for layer in range(n_layers)]
    vs = [heads(vc, layer) for layer in range(n_layers)]
    qh = q.reshape(B, n_heads, 1, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = time_ms(lambda i: sdpa(qh, ks[i % n_layers],
                                     vs[i % n_layers]), 240)
    bnd = bound(k1_bytes(pos, B, False, d), k1_flops(pos, B, d))
    print(f'K1 {label}, bf16, pos {pos} B {B} d {d} heads {n_heads}: kernel '
          f'{kernel:.5f} ms, plain {plain:.5f} ms, SDPA {library:.5f} ms, '
          f'bound {bnd[0]:.5f} ms ({bnd[1]}; kernel {kernel / bnd[0]:.2f}x)')
    del kc, vc, ks, vs
    torch.cuda.empty_cache()
    return kernel, plain, library, bnd


def time_k1_other_shapes(da):
    """K1 beside its plain version, SDPA and its bound at Transformer1d's
    T 319 (pos 64, 191, 318), the text path's T 127 (pos 95, 126) and
    FFHQ's d 1024 (pos 33). Returns Transformer1d's times at pos 191, the
    mean row count of its positions 64..318."""
    out = {pos: time_k1_shape(da, T_FLAT, D, NH, pos, f'T {T_FLAT}')
           for pos in FLAT_POSITIONS}
    for pos in (95, 126):
        time_k1_shape(da, T_TXT, D, NH, pos, f'T {T_TXT}')
    time_k1_shape(da, T, D_FFHQ, NH_FFHQ, 33, f'T {T}')
    return out[191]


def time_k2_joint(st):
    """K2 at the bidirectional mode's joint draw, bf16 [640, 8192] at
    top-k 2048, T 0.95: its codes against the plain version's on shared
    uniforms (`compare_draws`), then its times. Returns (max |code -
    plain|, (kernel, plain, library, bound))."""
    g = torch.Generator(device='cuda').manual_seed(17)
    logits = (torch.randn((K2_JOINT_ROWS, V), generator=g, device='cuda') *
              3).bfloat16()
    u = torch.rand(K2_JOINT_ROWS, generator=g, device='cuda')
    k, temp = 2048, 0.95
    thr = torch.empty(K2_JOINT_ROWS, device='cuda')
    c1 = st.sample_topk(logits, u, k, temp, threshold=thr).long()
    c2 = st.sample_topk_plain(logits, u, k, temp).long()
    x = st.scaled_logits(logits, temp)
    torch.cuda.synchronize()
    kept = x >= st.topk_threshold(x, k)
    require(torch.equal(kept, x >= thr[:, None]),
            'K2 joint draw kept set differs from the plain threshold\'s')
    require(kept[torch.arange(K2_JOINT_ROWS, device='cuda'), c1].all(),
            'K2 joint draw code outside the kept set')
    n_differ, err = compare_draws(x, kept, u, c1, c2, k, 'joint draw')
    print(f'K2 bf16 [{K2_JOINT_ROWS}, {V}] k {k} (bidirectional joint '
          f'draw): codes in the kept set, {n_differ} rows differ from plain '
          f'at a CDF boundary')
    return err, time_k2_shape(st, K2_JOINT_ROWS, k, temp)


@contextlib.contextmanager
def nucleus_draws():
    """Every top-p draw while the context is open, checked on the card:
    the code has a weight above zero in the plain filter's renormalised
    probabilities (`nucleus_probs`, the kept set). Yields a list that
    receives the count of draws and of codes outside the kept set. The
    depth runs eagerly meanwhile (`tracing.recording()`)."""
    from hqtransformer_tpu_torch.ops import topk_topp
    from hqtransformer_tpu_torch.utils import tracing
    real = topk_topp.inverse_cdf_draw
    outside = torch.zeros((), dtype=torch.long, device='cuda')
    draws = [0]

    def spy(probs, u):
        codes = real(probs, u)
        outside.add_((probs.gather(1, codes[:, None].long()) <= 0).sum())
        draws[0] += 1
        return codes
    topk_topp.inverse_cdf_draw = spy
    result = []
    try:
        with tracing.recording():    # eager: a graph's replay calls no spy
            yield result
    finally:
        topk_topp.inverse_cdf_draw = real
        result += [draws[0], int(outside)]


@torch.inference_mode()
def decode_pair(model, top, bottom, cell_win):
    """Pixels in [0, 1] of top codes [n, N] and bottom codes, cells
    [n, N, r] (cell_win given) or a raster [n, 4 N] (cell_win None),
    through `model`'s stage-1 decode (its loaded weights)."""
    from hqtransformer_tpu_torch.models.stage2.hierarchical import \
        cells_to_raster

    tr = model.top_res
    if cell_win is not None:
        bottom = cells_to_raster(bottom, tr, cell_win)
    px = model.stage1.decode_code(top.reshape(-1, tr, tr),
                                  bottom.reshape(-1, 2 * tr, 2 * tr))
    return torch.clamp(px * 0.5 + 0.5, 0.0, 1.0)


def run_depth_modes(da, st, q8):
    """The released `-bidirectional` and `-causal` (top2bot) configs through
    make_pixel_sampler at top-k 2048, T 0.95, twice each, and their AR
    loops profiled. Returns the bidirectional call's K2 launches."""
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    params = SamplingParams(**SAMPLING_2048)
    joint = None
    for path, mode in ((BIDIR_S2, 'bidirectional'), (CAUSAL_S2, 'top2bot')):
        model, weights, labels = bf16_model(
            path, lambda cfg: torch.arange(B) % cfg.stage2.hparams.n_classes)
        require(model.stage2.depth_mode == mode, f'{path.name} is not the '
                f'{mode} depth mode')
        sampler = model.make_pixel_sampler(params=params)
        gen = torch.Generator(device='cuda').manual_seed(1)
        for call in (1, 2):
            sampler_call(model, weights, sampler, gen, labels,
                         f'{mode} bf16 call {call}', da, st, q8)
        joint = joint or since_reset('k2.launches')
        ar_loop_profile(model, weights, params, labels, gen, mode)
        del model, weights
        torch.cuda.empty_cache()
    return joint


def ar_loop_profile(model, weights, params, labels, gen, name, int8=None,
                    scales=None):
    """The AR loop alone, timed and profiled (`profile_phases`); `int8`
    and `scales` as the sampler takes them."""
    from hqtransformer_tpu_torch.ops.int8 import Int8Serving
    from hqtransformer_tpu_torch.sampling.engine import \
        make_hierarchical_sampler

    model.load_weights(weights)
    sampler = make_hierarchical_sampler(
        model.stage2, model.top_res * model.top_res, params,
        int8 or Int8Serving(), scales)
    profile_phases(((f'{name} AR loop', lambda: sampler(gen, labels)),))


def run_given_top_and_top_p(da, st, q8):
    """The flagship with use_given_top (seeded random top codes; codes_t
    must equal them, the bottoms drawn under them: 128 K2) and with top-k
    2048 then top-p 0.95 at both levels (no K2 launch; every draw inside
    the plain filter's kept set), twice each; the top-p AR loop
    profiled."""
    from hqtransformer_tpu_torch.sampling.engine import (
        SamplingParams, make_hierarchical_sampler)

    model, weights, labels = bf16_model(
        FLAGSHIP, lambda cfg: torch.arange(B) % cfg.stage2.hparams.n_classes)
    n_top = model.top_res * model.top_res
    given = torch.randint(0, V, (B, n_top), device='cuda',
                          generator=torch.Generator(device='cuda')
                          .manual_seed(5))
    forced = make_hierarchical_sampler(
        model.stage2, n_top, SamplingParams(**SAMPLING_2048),
        use_given_top=True)
    gen = torch.Generator(device='cuda').manual_seed(1)

    def given_call():
        model.load_weights(weights)
        codes = forced(gen, labels, given)
        return decode_pair(model, *codes, model.cell_win), codes
    for call in (1, 2):
        codes, _ = checked_call(model, given_call, labels,
                                f'flagship use_given_top call {call}', da,
                                st, q8, decode_chunk=labels.shape[0])
        require(torch.equal(codes[0], given.int()),
                'use_given_top codes_t differ from the given codes')
    print('use_given_top: codes_t equal the given codes')
    sampler = model.make_pixel_sampler(
        params=SamplingParams(**SAMPLING_TOP_P))
    for call in (1, 2):
        with nucleus_draws() as seen:
            sampler_call(model, weights, sampler, gen, labels,
                         f'flagship top-k 2048 top-p 0.95 call {call}', da,
                         st, q8, top_p=True)
        require(seen == [2 * n_top, 0], f'top-p draws, codes outside the '
                f'kept set: {seen}')
        print(f'top-p call {call}: {seen[0]} draws, every code inside the '
              f'plain filter\'s kept set')
    ar_loop_profile(model, weights, SamplingParams(**SAMPLING_TOP_P), labels,
                    gen, 'top-p')
    del model, weights
    torch.cuda.empty_cache()


def run_flat_baselines(da, st, q8):
    """`vqvae2-l12-top8x8.yaml` (IGPT) through make_pixel_sampler_igpt
    (top-k 256, T 1.0), twice; then `vqvae2-l4-cond-top8x8-pred-bot16x16`
    (Transformer1d) through make_txt2img_sampler (top-k 256, T 1.0) with
    the IGPT call's top codes as its 64-token prefix, twice, its bottom
    codes and the top codes decoded together by the IGPT model's stage 1;
    both AR loops profiled. Returns Transformer1d's K1 launches of a call."""
    from hqtransformer_tpu_torch.sampling.engine import (make_igpt_sampler,
                                                         make_txt2img_sampler)

    top_model, top_weights, labels = bf16_model(
        IGPT_S2, lambda cfg: torch.arange(B) % cfg.stage2.hparams.n_classes)
    sampler = top_model.make_pixel_sampler_igpt()
    gen = torch.Generator(device='cuda').manual_seed(1)
    for call in (1, 2):
        top_codes, _ = sampler_call(top_model, top_weights, sampler, gen,
                                    labels, f'IGPT bf16 call {call}', da, st,
                                    q8)
    igpt = make_igpt_sampler(top_model.stage2, 64, top_k=256)
    profile_phases((('IGPT AR loop', lambda: igpt(gen, labels)),))
    bot_model, bot_weights, _ = bf16_model(TXT2IMG_S2, lambda cfg: labels)
    require(bot_model.stage2.sos_len == N_FLAT_TXT and
            bot_model.config.stage2.hparams.ctx_len_img == N_FLAT_IMG,
            'the bottom model is not a 64-token prefix to 256 codes')
    txt2img = make_txt2img_sampler(bot_model.stage2, N_FLAT_IMG, top_k=256)
    prefix = top_codes.long()

    def pair_call():
        bot_model.load_weights(bot_weights)
        bottom = txt2img(gen, prefix)
        top_model.load_weights(top_weights)
        return decode_pair(top_model, top_codes, bottom, None), bottom
    for call in (1, 2):
        checked_call(bot_model, pair_call, prefix,
                     f'Transformer1d bf16 call {call} (+ stage-1 decode of '
                     f'top and bottom)', da, st, q8, stage1=top_model.stage1,
                     decode_chunk=prefix.shape[0])
    k1 = since_reset('k1.launches')
    bot_model.load_weights(bot_weights)
    profile_phases((('Transformer1d AR loop',
                     lambda: txt2img(gen, prefix)),))
    del top_model, top_weights, bot_model, bot_weights
    torch.cuda.empty_cache()
    return k1


def run_other_samplers(da, st, q8):
    """Phase 11: K1 at Transformer1d's cache and K2 at the joint draw
    against their plain versions and timed (K1 also at phase 10's shapes,
    beside its plain version and SDPA); the depth modes, use_given_top,
    top-p and the flat baselines at full width. Returns the JSON rows'
    numbers: ((K1 launches, err, times), (K2 launches, err, times))."""
    t0 = time.perf_counter()
    k1_err = check_k1_flat(da)
    k1_times = time_k1_other_shapes(da)
    k2_err, k2_times = time_k2_joint(st)
    k2_launches = run_depth_modes(da, st, q8)
    run_given_top_and_top_p(da, st, q8)
    k1_launches = run_flat_baselines(da, st, q8)
    print(f'phase 11 (the other samplers): {time.perf_counter() - t0:.1f} s')
    return ((k1_launches, k1_err, k1_times),
            (k2_launches, k2_err, k2_times))


def tiny_conditioned_config(cond, embedding):
    """The tiny 2-level config (d 128, 4 heads) with `cond` ('text', an
    8-token caption of a 32-token vocabulary, or 'none') and `embedding`."""
    from hqtransformer_tpu_torch.config import build_twostage_config

    cfg = build_twostage_config(str(TINY))
    s2 = cfg.stage2
    s2.use_cls_cond, s2.use_txt_cond = False, cond == 'text'
    s2.vocab_size_txt, s2.hparams.ctx_len_txt = 32, 8
    s2.hparams.embedding_type = embedding
    return cfg


def check_conditioned_reference():
    """A tiny text model and a tiny unconditional `reduce` model, f32:
    their teacher-forced logits (the text logits too) on the card within
    1e-4 of the CPU's."""
    from hqtransformer_tpu_torch.models.twostage import (build_stage2,
                                                         random_state)

    for cond, embedding in (('text', 'transformer1'), ('none', 'reduce')):
        cfg = tiny_conditioned_config(cond, embedding)
        cpu = build_stage2(cfg).eval()
        state = random_state(cpu, torch.Generator().manual_seed(7))
        cpu.load_state_dict(state)
        gpu = build_stage2(cfg).cuda().eval()
        gpu.load_state_dict(state)
        g = torch.Generator().manual_seed(8)
        V2 = cfg.stage2.vocab_size_img
        ct = torch.randint(0, V2, (8, 16), generator=g)
        cb = torch.randint(0, V2, (8, 64), generator=g)
        labels = (torch.randint(0, 32, (8, 8), generator=g) if cond == 'text'
                  else torch.zeros(8, dtype=torch.long))
        with torch.inference_mode():
            ref = cpu(ct, cb, labels)
            out = gpu(ct.cuda(), cb.cuda(), labels.cuda())
        require(len(out) == (3 if cond == 'text' else 2),
                f'tiny {cond} forward gave {len(out)} outputs')
        err = max((o.cpu() - r).abs().max().item() for o, r in zip(out, ref))
        require(err <= 1e-4, f'tiny {cond} {embedding} logits differ by '
                f'{err}')
        print(f'tiny {cond} {embedding} teacher-forced logits: max|card - '
              f'cpu| = {err:.2e} over {[tuple(o.shape) for o in out]}')


def check_other_samplers_reference():
    """Tiny f32 models of phase 11's paths (d 128, 4 heads; the
    bidirectional and top2bot depth modes, IGPT over 16 codes,
    Transformer1d over 64 after a 16-token prefix) with the same seeded
    weights, greedy (top-k 1), sampled through the CUDA kernels and through
    the CPU plain versions: the codes equal."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.models.twostage import (build_stage2,
                                                         random_state)
    from hqtransformer_tpu_torch.sampling.engine import (
        SamplingParams, make_hierarchical_sampler, make_igpt_sampler,
        make_txt2img_sampler)

    g = torch.Generator().manual_seed(10)
    labels = torch.arange(8) % 10
    prefix = torch.randint(0, 256, (8, 16), generator=g)
    for kind in ('hq-transformer/bidirectional4', 'hq-transformer', 'top',
                 'bottom'):
        cfg = build_twostage_config(str(TINY))
        cfg.stage2.type = kind
        if kind == 'bottom':
            cfg.stage2.hparams.ctx_len_img = 64
            cfg.stage2.hparams.ctx_len_txt = 16
        cpu = build_stage2(cfg).eval()
        state = random_state(cpu, torch.Generator().manual_seed(9))
        cpu.load_state_dict(state)
        gpu = build_stage2(cfg).cuda().eval()
        gpu.load_state_dict(state)
        codes = []
        for m, dev in ((cpu, 'cpu'), (gpu, 'cuda')):
            gen = torch.Generator(device=dev)
            if kind == 'top':
                out = make_igpt_sampler(m, 16, top_k=1)(gen, labels.to(dev))
            elif kind == 'bottom':
                out = make_txt2img_sampler(m, 64, top_k=1)(gen,
                                                           prefix.to(dev))
            else:
                out = make_hierarchical_sampler(
                    m, 16, SamplingParams(top_k_top=1, top_k_bot=1))(
                        gen, labels.to(dev))
            codes.append([c.cpu() for c in
                          (out if isinstance(out, tuple) else (out,))])
        require(all(torch.equal(a, b) for a, b in zip(*codes)),
                f'tiny {kind} greedy codes differ between card and CPU')
        print(f'tiny {kind} greedy codes: card equal to CPU '
              f'({[tuple(c.shape) for c in codes[0]]})')


# ------------------------------------------ phase 12: the rest of stage 1

AVGPOOL = ROOT / 'configs/imagenet/stage1/hqvae-avgpool-top8x8.yaml'
CONV2 = ROOT / 'configs/imagenet/stage1/hqvae-conv2-pixelrecon-top8x8.yaml'
SOFT_S2 = ROOT / 'configs/imagenet/stage2/hqtransformer-l12-top8x8-soft.yaml'
SOFT_ROW_TOL = 1e-4


def launch_counts(vq, da, st):
    return (since_reset('k3.launches'), since_reset('k1.launches'),
            since_reset('k2.launches'))


def run_resampler_reconstruction(vq, da, st, path, seed):
    """make_reconstructor on a released stage-1 config at batch 128 with
    seeded random weights: twice in bf16 (bf16 serving weights) and once in
    f32 (TF32 off), each with 2 K3 and no K1, K2 launches, codes in range
    and pixels finite in [-1, 1]; then the bf16 call broken down. Returns
    ({dtype: images/s of the last call}, K3 launches of a bf16 call, the
    config, its bf16 weights, the images)."""
    from hqtransformer_tpu_torch.config import build_stage1_config
    from hqtransformer_tpu_torch.evaluation.stage1 import (
        init_stage1_weights, make_reconstructor)
    from hqtransformer_tpu_torch.models.twostage import serving_bf16_params

    cfg = build_stage1_config(str(path)).stage1
    res = cfg.hparams.resolution
    w32 = init_stage1_weights(cfg, seed=seed)
    w16 = serving_bf16_params(w32)
    images = seeded_images(B, res, seed=seed)
    rates, k3 = {}, None
    for dtype, weights, calls in ((torch.bfloat16, w16, (1, 2)),
                                  (torch.float32, w32, (1,))):
        recon = make_reconstructor(cfg, dtype)
        for call in calls:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts('k3.launches', 'k1.launches', 'k2.launches')
            t0 = time.perf_counter()
            pixels, levels = recon(weights, images)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = launch_counts(vq, da, st)
            require(launches == (2, 0, 0), f'{path.stem} launches K3, K1, '
                    f'K2 {launches}, expected (2, 0, 0)')
            check_reconstruction(pixels, levels, B, res, (8, 16))
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f'{path.stem} {str(dtype)[6:]} reconstruction call {call}: '
                  f'{seconds:.3f} s, {B / seconds:.2f} images/s at batch '
                  f'{B}, peak {peak:.2f} GiB, launches K3={launches[0]} '
                  f'({pair_list(vq, dtype, dtype)})')
            if dtype == torch.bfloat16:
                k3 = launches[0]
        rates[dtype] = B / seconds
    del w32
    encode_breakdown(cfg, w16, images, f'{path.stem} ')
    return rates, k3, cfg, w16, images


def run_bottom_bypass(vq, da, st, cfg, weights, images):
    """The generator's forward with bottom_bypass (the `bottom_start`
    curriculum, 0 in the conv2 config), bf16: the pixels of the top codes
    alone and of both, finite, with 2 K3 launches."""
    from hqtransformer_tpu_torch.models.stage1.generator import \
        build_generator

    with torch.device('meta'):
        gen = build_generator(cfg, torch.bfloat16)
    gen = gen.to_empty(device='cuda').eval()
    gen.load_state_dict(weights, strict=True, assign=True)
    torch.cuda.synchronize()
    reset_counts('k3.launches', 'k1.launches', 'k2.launches')
    t0 = time.perf_counter()
    with torch.inference_mode():
        (dec_t, dec), _, codes = gen(images, bottom_bypass=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts(vq, da, st)
    require(launches == (2, 0, 0), f'bottom_bypass launches K3, K1, K2 '
            f'{launches}, expected (2, 0, 0)')
    for d in (dec_t, dec):
        require(tuple(d.shape) == tuple(images.shape) and
                bool(torch.isfinite(d).all()), 'bottom_bypass pixels')
    require(not torch.equal(dec_t, dec), 'bottom_bypass top-only pixels '
            'equal the full decode')
    print(f'{cfg.hparams_aux.upsample} forward(bottom_bypass=True) at batch '
          f'{B}: {seconds * 1e3:.1f} ms, launches K3={launches[0]}, pixels '
          f'{tuple(dec_t.shape)} and {tuple(dec.shape)} finite')


def soft_argmin_check(model, images, codes):
    """The soft path's hard codes are the argmin of the f32 distances that
    its soft maps are the softmax of, recomputed here level by level."""
    from hqtransformer_tpu_torch.ops import quantize as q
    from hqtransformer_tpu_torch.ops.vq_argmin import codebook_distances

    gen, (ct, cb) = model.stage1, codes
    with torch.inference_mode():
        h_b = gen._encode_map(images)
        z_t = gen.down_t(h_b)
        d_t = codebook_distances(z_t.reshape(-1, z_t.shape[-1]),
                                 gen.quantize_t.codebook)
        require(torch.equal(d_t.argmin(1).reshape(ct.shape), ct),
                'soft top codes are not the argmin of their distances')
        quant_t = q.straight_through(
            z_t, gen.quantize_t.get_codebook_entry(ct.reshape(
                z_t.shape[:-1])))
        r = h_b - gen.upsample_t(quant_t)
        d_b = codebook_distances(r.reshape(-1, r.shape[-1]),
                                 gen._bottom_quantizer.codebook)
        require(torch.equal(d_b.argmin(1).reshape(cb.shape), cb),
                'soft bottom codes are not the argmin of their distances')


def run_soft_codes(vq, da, st):
    """TwoStageModel.extract_codes(temp_soft_labels) on the soft-label
    config at batch 128, bf16 weights, twice: no K3 launch (the soft path
    takes argmin of its f32 distances, as JAX routes it), soft maps
    [128, T, 8192] whose rows sum to 1 within SOFT_ROW_TOL, hard codes the
    argmin of those distances; their agreement with the K3 codes of a
    plain extract_codes; one stochastic call."""
    model, weights, _ = bf16_model(
        SOFT_S2, lambda cfg: torch.zeros(B, dtype=torch.long))
    temp = model.config.stage2.temp_soft_labels
    res = model.config.dataset.image_resolution
    images = seeded_images(B, res, seed=10)
    for call in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts('k3.launches', 'k1.launches', 'k2.launches')
        t0 = time.perf_counter()
        codes, softs = model.extract_codes(weights, images,
                                           temp_soft_labels=temp)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts(vq, da, st)
        require(launches == (0, 0, 0), f'soft extract_codes launches K3, '
                f'K1, K2 {launches}, expected none')
        require([tuple(c.shape) for c in codes] == [(B, 64), (B, 256)] and
                [tuple(t.shape) for t in softs] ==
                [(B, 64, N_CODES), (B, 256, N_CODES)],
                f'soft shapes {[tuple(t.shape) for t in softs]}')
        row_err = max(float((t.sum(-1) - 1).abs().max()) for t in softs)
        require(row_err <= SOFT_ROW_TOL, f'soft rows sum to 1 +- {row_err}')
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'soft extract_codes (temp {temp}) call {call} at batch {B}: '
              f'{seconds * 1e3:.1f} ms, peak {peak:.2f} GiB, launches '
              f'K3={launches[0]}, rows sum to 1 within {row_err:.2e}')
    soft_argmin_check(model, images, codes)
    reset_counts('k3.launches')
    hard, _ = model.extract_codes(weights, images)
    require(since_reset('k3.launches') == 2,
            'plain extract_codes did not run K3')
    agree = [float((a == b).float().mean()) for a, b in zip(codes, hard)]
    print(f'soft hard codes: the argmin of their distances; equal to the K3 '
          f'codes of a plain extract_codes in {agree[0]:.4%} (top), '
          f'{agree[1]:.4%} (bottom) of positions')
    gen = torch.Generator(device='cuda').manual_seed(11)
    reset_counts('k3.launches')
    drawn, _ = model.extract_codes(weights, images, temp_soft_labels=temp,
                                   generator=gen)
    require(since_reset('k3.launches') == 0, 'stochastic soft codes ran K3')
    for c in drawn:
        require(int(c.min()) >= 0 and int(c.max()) < N_CODES,
                'stochastic soft codes out of range')
    same = [float((a == b).float().mean()) for a, b in zip(drawn, codes)]
    print(f'stochastic soft codes: in range; equal to the argmin in '
          f'{same[0]:.4%} (top), {same[1]:.4%} (bottom) of positions')


def stage1_tiny_config(name):
    """The tiny config's stage 1 (32^2 images, 256 codes of dim 64) as a
    generator no released config builds or as a released resampler."""
    import dataclasses

    from hqtransformer_tpu_torch.config import build_twostage_config

    cfg = build_twostage_config(str(TINY)).stage1
    kind, *rest = name.split('-')
    aux = dataclasses.replace(cfg.hparams_aux, upsample=rest[0] if rest
                              else None, decoding_type=rest[1] if
                              len(rest) > 1 else 'concat')
    hp = cfg.hparams
    if name == 'vqgan2-nearest-sum':
        # its encoder's 16^2 map and decoder_top's add: equal widths
        hp = dataclasses.replace(hp, ch_mult=[2, 2])
    if kind == 'hqvae3':
        kind, aux.code_levels = 'hqvae', 3
    return dataclasses.replace(cfg, type=kind, hparams=hp, hparams_aux=aux,
                               ema_update=kind != 'vqgan',
                               n_embed_levels=[64, 128, 256])


STAGE1_TINY = ('vqgan', 'vqgan2-deconv2d-concat', 'vqgan2-nearest-sum',
               'simrqgan2-nearest', 'simrqgan2-conv2', 'hqvae3-conv2')


@contextlib.contextmanager
def k3_inputs():
    """The (z, codebook) of every nearest-code search while the context is
    open (a spy on the name `ops/quantize.py::vq_lookup` calls)."""
    from hqtransformer_tpu_torch.ops import quantize as q
    real, seen = q.vq_argmin, []

    def spy(z, e):
        seen.append((z, e))
        return real(z, e)

    q.vq_argmin = spy
    try:
        yield seen
    finally:
        q.vq_argmin = real


def check_stage1_variants_reference(vq):
    """Tiny f32 versions of the generators only this slice runs (VQGAN
    with its learned codebook, VQGAN2 in both upsample modes and decoding
    types, the 2-level HQ-VAE with nearest and conv2, the 3-level one with
    conv2), seeded weights: make_reconstructor through K3 on the card and
    through the CPU plain path on the same images, codes equal, pixels
    within 1e-3. A level's codes may differ only as phase 4 allows K3 to,
    at rows whose two distances tie within f32 rounding (`compare_codes`
    on the CPU's search inputs, at most 1% of rows; these seeds put rows
    1.3 f32 steps of |z|^2 + |e|^2 from a tie); the levels below such a
    level and the pixels then follow different codes and are not
    compared."""
    from hqtransformer_tpu_torch.evaluation.stage1 import (
        init_stage1_weights, make_reconstructor)

    images = seeded_images(8, 32, seed=12, device='cpu')
    for i, name in enumerate(STAGE1_TINY):
        cfg = stage1_tiny_config(name)
        weights = init_stage1_weights(cfg, seed=20 + i, device='cpu')
        with k3_inputs() as searched:
            ref_px, ref_levels = make_reconstructor(cfg, device='cpu')(
                weights, images)
        reset_counts('k3.launches')
        px, levels = make_reconstructor(cfg, device='cuda')(
            {k: v.cuda() for k, v in weights.items()}, images.cuda())
        torch.cuda.synchronize()
        k3 = since_reset('k3.launches')
        require(k3 == len(ref_levels),
                f'tiny {name} launched K3 {k3} times')
        shapes = [tuple(c.shape) for c in levels]
        for li, (c, ref, (z, e)) in enumerate(zip(levels, ref_levels,
                                                  searched)):
            if not torch.equal(c.cpu(), ref):
                n_diff, gap = compare_codes(z, e, c.cpu().flatten(),
                                            ref.flatten(), max_share=0.01)
                print(f'tiny {name} reconstruction: level {li} of {shapes} '
                      f'takes the other code of a near-tie in {n_diff} '
                      f'rows (f64 gap {gap:.2e}); the levels above equal '
                      f'the CPU plain path')
                break
        else:
            err = (px.cpu() - ref_px).abs().max().item()
            require(err <= 1e-3, f'tiny {name} pixels differ by {err}')
            print(f'tiny {name} reconstruction: codes of {shapes} equal to '
                  f'the CPU plain path, max|pixels - cpu| = {err:.2e}')


def run_stage1_rest(vq, da, st):
    """Phase 12. Returns ({config stem: {dtype: images/s}}, K3 launches of
    an avgpool / conv2 bf16 reconstruction)."""
    t0 = time.perf_counter()
    rates, k3 = {}, None
    for path, seed in ((AVGPOOL, 13), (CONV2, 14)):
        rates[path.stem], k3, cfg, w16, images = \
            run_resampler_reconstruction(vq, da, st, path, seed)
    run_bottom_bypass(vq, da, st, cfg, w16, images)
    del w16, images
    torch.cuda.empty_cache()
    run_soft_codes(vq, da, st)
    torch.cuda.empty_cache()
    print(f'phase 12 (the rest of stage 1): {time.perf_counter() - t0:.1f} s')
    return rates, k3


# ------------------- phase 13: int8 serving of every sampler, and the CLIs

# K1's int8 kernel on Transformer1d's cache (4 layers, T_FLAT rows): the
# first and last step, and the rounds between.
K1_INT8_FLAT_LAYERS = 4
K1_INT8_FLAT_POSITIONS = (64, 191, 255, 318)
# per spatial layer and position of a 2-level sampler: the fused QKV,
# proj, mlp.0 and mlp.2 gemms, A8W8 under spatial_gemms
SPATIAL_GEMMS = 4
CLI_CAPTIONS = ('A red fox in the snow, in watercolor.',
                'Two old sailboats beside a lake at dusk.',
                'A bowl of ramen on a wooden table.',
                'A lighthouse on a cliff, as a pencil sketch.')


def check_k1_int8_flat(da):
    """K1's int8 kernel against its plain version on Transformer1d's cache
    (L 4, T_FLAT rows, d 1536, 24 heads) at K1_INT8_FLAT_POSITIONS, batch
    128 and 1024: caches bit-equal, y within 2e-2 in units of 1/127
    (`k1_case`, phase 7's bound). Returns the largest |y - plain| / 127."""
    err = 0.0
    for batch in (B, B_LARGE):
        for pos in K1_INT8_FLAT_POSITIONS:
            layer = pos % K1_INT8_FLAT_LAYERS
            e = k1_case(da, 'int8', K1_INT8_FLAT_LAYERS, T_FLAT, batch, D,
                        NH, pos, layer, seed=pos + batch + 1)
            err = max(err, e)
            print(f'K1 int8 cache, bf16 q, L={K1_INT8_FLAT_LAYERS} '
                  f'T={T_FLAT} B={batch} layer={layer} pos={pos:3d}: caches '
                  f'bit-equal, max|y - plain| / 127 = {e:.3e} (tol 2e-2)')
        torch.cuda.empty_cache()
    return err


def time_k1_int8_flat(da):
    """K1's int8 kernel at batch 128 on Transformer1d's cache at each of
    K1_INT8_FLAT_POSITIONS, beside its plain version and its bound (the
    int8 rows read once); the calls rotate over enough layers to hold
    K1_ROTATE_BYTES. No PyTorch call attends over an int8 cache: no
    library time. Returns {pos: (kernel, plain, None, bound)}."""
    out = {}
    for pos in K1_INT8_FLAT_POSITIONS:
        n_layers = max(4, -(-K1_ROTATE_BYTES // (2 * (pos + 1) * B * D)))
        g = torch.Generator(device='cuda').manual_seed(pos + 3)
        kc, vc = (torch.randint(-128, 128, (n_layers, T_FLAT, B, D),
                                generator=g, device='cuda', dtype=torch.int8)
                  for _ in range(2))
        kn, vn = (torch.randint(-128, 128, (B, D), generator=g,
                                device='cuda', dtype=torch.int8)
                  for _ in range(2))
        q = (torch.randn((B, D), generator=g, device='cuda') *
             0.02).bfloat16()
        kernel = time_ms(lambda i: da.decode_attention_step(
            q, kn, vn, kc, vc, i % n_layers, pos, NH), 240)
        plain = time_ms(lambda i: da.decode_attention_step_plain(
            q, kn, vn, kc, vc, i % n_layers, pos, NH), 24)
        bnd = bound(k1_bytes(pos, B, True), k1_flops(pos, B))
        print(f'K1 int8 cache, T {T_FLAT}, bf16 q, pos {pos} B {B}: kernel '
              f'{kernel:.5f} ms, plain {plain:.5f} ms, bound {bnd[0]:.5f} ms '
              f'({bnd[1]}; kernel {kernel / bnd[0]:.2f}x)')
        out[pos] = (kernel, plain, None, bnd)
        del kc, vc
        torch.cuda.empty_cache()
    return out


def run_int8_depth_modes(da, st, q8):
    """`-bidirectional` and `-causal` (top2bot) in int8max: two bf16
    calls, the three calibrations as measure_throughput takes them (its
    `calibrate`), two int8max calls of make_pixel_sampler (756
    K1 launches, all int8; 64 or 320 K2; exactly the spatial gemms A8W8,
    12 layers x 4 at the prefill and the 63 steps: the depth passes and
    head_bot float), samples/s and peak memory beside bf16's, the code
    agreement with bf16 on one generator seed, and the int8max AR loop
    profiled."""
    from hqtransformer_tpu_torch.cli.measure_throughput import calibrate
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    params = SamplingParams(**SAMPLING_2048)
    for path, mode in ((BIDIR_S2, 'bidirectional'), (CAUSAL_S2, 'top2bot')):
        model, weights, labels = bf16_model(
            path, lambda cfg: torch.arange(B) % cfg.stage2.hparams.n_classes)
        n_top = model.top_res * model.top_res
        spatial = model.config.stage2.hparams.n_layers * SPATIAL_GEMMS * n_top
        bf16 = model.make_pixel_sampler(params=params)
        gen = torch.Generator(device='cuda').manual_seed(1)
        for call in (1, 2):
            out, rate16 = sampler_call(model, weights, bf16, gen, labels,
                                       f'{mode} bf16 call {call} (phase 13)',
                                       da, st, q8)
            if call == 1:
                codes16 = out
        peak16 = torch.cuda.max_memory_allocated() / 2**30
        scales = calibrate({'serving': 'int8max', 'code_levels': 2}, model,
                           weights, labels, n_top)
        sampler = model.make_pixel_sampler(params=params, int8=q8.INT8MAX,
                                           scales=scales)
        gen = torch.Generator(device='cuda').manual_seed(1)
        for call in (1, 2):
            codes, rate = sampler_call(model, weights, sampler, gen, labels,
                                       f'{mode} int8max call {call}', da, st,
                                       q8, int8=True)
            gemms = since_reset('int8.matmul_launches')
            require(gemms == spatial,
                    f'{mode} int8max ran {gemms} A8W8 '
                    f'gemms, expected the {spatial} spatial ones only')
            if call == 1:
                agree = [float((a == b).float().mean())
                         for a, b in zip(codes, codes16)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(all(getattr(m, 'q8', None) is None
                    for m in model.stage2.modules()),
                f'{mode}: serving state left behind')
        print(f'{mode} int8max: {rate:.2f} samples/s, peak {peak:.2f} GiB '
              f'against bf16 {rate16:.2f} samples/s, {peak16:.2f} GiB in this '
              f'run ({rate / rate16:.2f}x); A8W8 gemms {spatial} a call, all '
              f'spatial; codes on one generator seed (random weights) equal '
              f'to bf16\'s: top {agree[0]:.2%}, bottom {agree[1]:.2%}')
        ar_loop_profile(model, weights, params, labels, gen,
                        f'{mode} int8max', q8.INT8MAX, scales)
        del model, weights, scales
        torch.cuda.empty_cache()


def run_int8_flat(da, st, q8):
    """The flat baselines with an int8 KV cache, scales from a float run
    (`_flat_kv_scales`): IGPT through make_pixel_sampler_igpt with the int8
    cache and the A8W8 decode (its scales on a bf16 call's top codes),
    twice (756 K1, all int8; 64 K2; int8 convolutions, no int8 gemm); then
    Transformer1d through make_txt2img_sampler with the int8 cache and 64
    prefix tokens, twice (1,020 K1 at pos 64..318, all int8; 256 K2; no
    A8W8), its codes decoded in bf16 with the top codes; each beside a
    bf16 call in this run, and both AR loops profiled. Returns
    Transformer1d's int8 K1 launches of a call."""
    from hqtransformer_tpu_torch.models.twostage import _flat_kv_scales
    from hqtransformer_tpu_torch.sampling.engine import (make_igpt_sampler,
                                                         make_txt2img_sampler)

    kv, kv_convs = (q8.Int8Serving(kv_cache=True),
                    q8.Int8Serving(kv_cache=True, decode_convs=True))
    top_model, top_weights, labels = bf16_model(
        IGPT_S2, lambda cfg: torch.arange(B) % cfg.stage2.hparams.n_classes)
    igpt16 = top_model.make_pixel_sampler_igpt()
    gen = torch.Generator(device='cuda').manual_seed(1)
    for call in (1, 2):
        out, rate16 = sampler_call(top_model, top_weights, igpt16, gen,
                                   labels, f'IGPT bf16 call {call} (phase 13)',
                                   da, st, q8)
        if call == 1:
            top16 = out
    top_model.load_weights(top_weights)
    scales = _flat_kv_scales(top_model.stage2,
                             torch.Generator(device='cuda').manual_seed(2),
                             labels, 64, top_k=256)
    scales.update(top_model.calibrate_int8_decode(
        top_weights, top16.reshape(-1, 8, 8), None))
    sampler = top_model.make_pixel_sampler_igpt(int8=kv_convs, scales=scales)
    gen = torch.Generator(device='cuda').manual_seed(1)
    for call in (1, 2):
        top_codes, rate = sampler_call(
            top_model, top_weights, sampler, gen, labels,
            f'IGPT int8 cache + int8 decode call {call}', da, st, q8,
            int8=True, a8w8=(False, True))
    print(f'IGPT int8 cache + int8 decode: {rate:.2f} samples/s against '
          f'bf16 {rate16:.2f} in this run ({rate / rate16:.2f}x); codes on '
          f'one generator seed equal to bf16\'s: '
          f'{float((top_codes == top16).float().mean()):.2%} (call 2)')
    top_model.load_weights(top_weights)
    igpt8 = make_igpt_sampler(top_model.stage2, 64, top_k=256, int8=kv,
                              scales=scales)
    profile_phases((('IGPT int8 cache AR loop', lambda: igpt8(gen, labels)),))

    bot_model, bot_weights, _ = bf16_model(TXT2IMG_S2, lambda cfg: labels)
    prefix = top_codes.long()
    bot_model.load_weights(bot_weights)
    bot_scales = _flat_kv_scales(
        bot_model.stage2, torch.Generator(device='cuda').manual_seed(3),
        prefix, N_FLAT_IMG, top_k=256)
    rates = {}
    for name, int8, sc in (('bf16', q8.Int8Serving(), None),
                           ('int8 cache', kv, bot_scales)):
        txt2img = make_txt2img_sampler(bot_model.stage2, N_FLAT_IMG,
                                       top_k=256, int8=int8, scales=sc)

        def pair_call():
            bot_model.load_weights(bot_weights)
            bottom = txt2img(gen, prefix)
            top_model.load_weights(top_weights)
            return decode_pair(top_model, top_codes, bottom, None), bottom
        for call in (1, 2):
            _, rates[name] = checked_call(
                bot_model, pair_call, prefix,
                f'Transformer1d {name} call {call} (+ bf16 stage-1 decode)',
                da, st, q8, int8=int8.kv_cache, a8w8=(False, False),
                stage1=top_model.stage1, decode_chunk=prefix.shape[0])
    k1 = since_reset('k1.int8_launches')
    print(f'Transformer1d int8 cache: {rates["int8 cache"]:.2f} samples/s '
          f'against bf16 {rates["bf16"]:.2f} in this run '
          f'({rates["int8 cache"] / rates["bf16"]:.2f}x)')
    bot_model.load_weights(bot_weights)
    profile_phases((('Transformer1d int8 cache AR loop',
                     lambda: txt2img(gen, prefix)),))
    del top_model, top_weights, bot_model, bot_weights
    torch.cuda.empty_cache()
    return k1


def run_cli(args, name, timeout=600):
    """One port CLI in a subprocess of its own (`python -m
    hqtransformer_tpu_torch.cli.<name>`), from the checkout's root: its
    stdout, and its wall seconds printed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m',
                           f'hqtransformer_tpu_torch.cli.{name}', *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f'cli.{name} exited {proc.returncode}:\n'
            f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
    print(f'cli.{name} {" ".join(args[:2])} ...: {seconds:.1f} s wall')
    return proc.stdout


def _pickle(path):
    import pickle
    with open(path, 'rb') as f:
        return pickle.load(f)


def run_clis():
    """The port's three CLIs, each in its own process, at full width:
    sampling_hqmodel from a Lightning-layout .ckpt of the flagship's seeded
    random weights in fp16 (2 classes of 128 samples: two pickles
    [128, 3, 256, 256] f32 in [0, 1]); measure_throughput in int8max,
    calibrating into an artifact, then measuring from it at batch 128 (its
    ms/sample lines); sampling_hqmodel_txt2img on CC15M with four captions
    and CLIP re-ranking of 4 candidates each by a seeded random ViT-B/32
    state dict (the ranked pickle, finite scores sorted best first)."""
    import tempfile

    import numpy as np

    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.evaluation.clip_rerank import CLIP
    from hqtransformer_tpu_torch.models.twostage import (TwoStageModel,
                                                         random_state)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        model = TwoStageModel(build_twostage_config(str(FLAGSHIP)))
        sd = {f'{stage}.{k}': t.half().cpu()
              for stage, w in model.init_weights(seed=0).items()
              for k, t in w.items()}
        torch.save({'state_dict': sd, 'epoch': 0}, tmp / 'model.ckpt')
        del model, sd
        torch.cuda.empty_cache()
        shutil.rmtree(SMOKE_SAMPLES, ignore_errors=True)
        out = run_cli(['-r', str(SMOKE_SAMPLES), '-m',
                       str(tmp / 'model.ckpt'), '-c', str(FLAGSHIP),
                       '--num-classes', '2', '--total-samples', '256',
                       '--batch-size', '128', '--top-k', '2048'],
                      'sampling_hqmodel')
        for ln in out.splitlines():
            if 'ms/sample' in ln:
                print(f'  {ln}')
        for c in (1, 2):
            px = _pickle(SMOKE_SAMPLES / f'samples_({c}_0).pkl')
            require(px.dtype == np.float32 and px.shape == (B, 3, 256, 256)
                    and np.isfinite(px).all() and px.min() >= 0 and
                    px.max() <= 1, f'cli samples_({c}_0).pkl: {px.dtype} '
                    f'{px.shape}')
        print('cli.sampling_hqmodel: samples_(1_0).pkl, samples_(2_0).pkl '
              f'f32 {(B, 3, 256, 256)} in [0, 1]')

        scales = str(tmp / 'scales.pkl')
        cfg = [f'model_path={FLAGSHIP}', 'serving=int8max']
        run_cli(cfg + [f'scales_out={scales}'], 'measure_throughput')
        out = run_cli(cfg + [f'scales_in={scales}', f'batch_size={B}',
                             'samples_per_loop=256', 'n_loop=2'],
                      'measure_throughput')
        lines = [ln for ln in out.splitlines() if 'ms/sample' in ln]
        require(len(lines) == 5 and lines[-1].startswith(f'bs{B} | '),
                f'measure_throughput printed {lines}')
        for ln in lines:
            print(f'  {ln}')

        (tmp / 'captions.txt').write_text('\n'.join(CLI_CAPTIONS) + '\n')
        with torch.device('meta'):
            clip = CLIP()
        clip_state = random_state(clip, torch.Generator().manual_seed(11))
        torch.save({k: t.half() for k, t in clip_state.items()},
                   tmp / 'clip.pt')
        del clip, clip_state
        n = len(CLI_CAPTIONS)
        run_cli(['-r', str(tmp / 'txt'), '-c', str(CC15M_S2),
                 '--random-init', '--captions', str(tmp / 'captions.txt'),
                 '--batch-size', str(n), '--clip-rerank', '4',
                 '--clip-weights', str(tmp / 'clip.pt')],
                'sampling_hqmodel_txt2img')
        px = _pickle(tmp / 'txt' / f'samples_(1_{n}).pkl')
        scores = np.load(tmp / 'txt' / f'clip_scores_(1_{n}).npz')['scores']
        require(px.shape == (n, 4, 3, 256, 256) and px.dtype == np.float32
                and np.isfinite(px).all(), f'cli txt2img samples {px.shape}')
        require(scores.shape == (n, 4) and np.isfinite(scores).all() and
                (np.diff(scores, axis=1) <= 0).all(),
                f'cli txt2img CLIP scores {scores}')
        print(f'cli.sampling_hqmodel_txt2img: samples_(1_{n}).pkl f32 '
              f'{px.shape}, CLIP scores sorted best first: '
              f'{np.round(scores, 4).tolist()}')
    print(f'the CLIs: {time.perf_counter() - t0:.1f} s')


@torch.inference_mode()
def forced_depth_logits(model, labels, top, bottoms, int8, scales):
    """The serving loop of a `bidirectional` or `top2bot` 2-level model
    with the given codes in place of draws (top [n, N], bottoms
    [n, N, ratio]): every position's depth logits [n, N, 1 + ratio, V],
    as the mode's sampler computes them (the JAX package has no scorer
    for these modes; this one exists for the card-against-CPU check)."""
    from hqtransformer_tpu_torch.sampling.engine import _serving_loop

    m = model

    def depth(i, h):
        t, b = top[:, i], bottoms[:, i]
        if m.depth_mode == 'bidirectional':
            logits = torch.cat(m.depth_bidirectional(h), dim=1)
        else:
            kc, vc = m.depth_caches(h.shape[0], h.device)
            x = m.depth_causal_step(h[:, None] + m.sos_depth.to(h.dtype), kc,
                                    vc, 0)
            out = [m.head_top(m.ln_top(x[:, 0]))]
            prev = [t] + list(b.unbind(1))
            pos = m.pos_emb_depth.weight
            for step in range(1, m.len_seq_depth):
                table = m.tok_emb_top_depth if step == 1 else \
                    m.tok_emb_bot_depth
                x = m._emb(table, prev[step - 1]) + pos[step - 1].to(h.dtype)
                x = m.depth_causal_step(x[:, None], kc, vc, step)
                out.append(m.head_bot(m.ln_bot(x[:, 0])))
            logits = torch.stack(out, dim=1)
        return (t, b), logits.float()

    outs, _ = _serving_loop(m, labels, top.shape[1], int8, scales, depth)
    return torch.stack(outs, dim=1)


def check_int8_references():
    """Tiny models (d 128, 4 heads) of phase 13's paths with the same
    weights and scales on the card and on the CPU plain path:
    - the bidirectional and top2bot modes, IGPT over 16 codes and
      Transformer1d over 64 after a 16-token prefix, f32 with an int8 KV
      cache (scales from a CPU float run), greedy (top-k 1): the codes
      equal;
    - the bidirectional and top2bot modes in int8max (bf16, scales
      calibrated on the CPU), teacher-forced on seeded codes: top-1
      agreement of the depth logits >= 90%, the repo's bound for int8
      logits (tests/test_torch_int8.py). Greedy bf16 codes cannot be held
      equal: K1's int8 kernel gives y within a bf16 step of its plain
      version (phase 7's bound), and a near-tie that flips then changes
      every later position."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.models.stage2.hierarchical import \
        cells_to_raster
    from hqtransformer_tpu_torch.models.twostage import (
        TwoStageModel, _flat_kv_scales, _kv_scales, build_stage2,
        random_state, serving_bf16_params)
    from hqtransformer_tpu_torch.ops.int8 import INT8MAX, Int8Serving
    from hqtransformer_tpu_torch.sampling.engine import (
        SamplingParams, make_hierarchical_sampler, make_igpt_sampler,
        make_txt2img_sampler)

    greedy = SamplingParams(top_k_top=1, top_k_bot=1)
    kv = Int8Serving(kv_cache=True)
    g = torch.Generator().manual_seed(12)
    labels = torch.arange(8) % 10
    prefix = torch.randint(0, 256, (8, 16), generator=g)
    for kind in ('hq-transformer/bidirectional4', 'hq-transformer', 'top',
                 'bottom'):
        cfg = build_twostage_config(str(TINY))
        cfg.stage2.type = kind
        if kind == 'bottom':
            cfg.stage2.hparams.ctx_len_img = 64
            cfg.stage2.hparams.ctx_len_txt = 16
        cpu = build_stage2(cfg).eval()
        state = random_state(cpu, torch.Generator().manual_seed(9))
        cpu.load_state_dict(state)
        gpu = build_stage2(cfg).cuda().eval()
        gpu.load_state_dict(state)
        cond, n = (prefix, 64) if kind == 'bottom' else (labels, 16)
        if kind.startswith('hq'):
            _, caches = make_hierarchical_sampler(
                cpu, n, greedy, return_caches=True)(torch.Generator(), cond)
            scales = _kv_scales(caches)
        else:
            scales = _flat_kv_scales(cpu, torch.Generator().manual_seed(2),
                                     cond, n, top_k=8)
        codes = []
        for m, dev in ((cpu, 'cpu'), (gpu, 'cuda')):
            gen, c = torch.Generator(device=dev), cond.to(dev)
            if kind == 'top':
                out = make_igpt_sampler(m, n, top_k=1, int8=kv,
                                        scales=scales)(gen, c)
            elif kind == 'bottom':
                out = make_txt2img_sampler(m, n, top_k=1, int8=kv,
                                           scales=scales)(gen, c)
            else:
                out = make_hierarchical_sampler(m, n, greedy, kv, scales)(
                    gen, c)
            codes.append([t.cpu() for t in
                          (out if isinstance(out, tuple) else (out,))])
        agree = [float((a == b).float().mean()) for a, b in zip(*codes)]
        require(all(a == 1.0 for a in agree), f'tiny {kind} f32 int8-cache '
                f'greedy codes: card equal to CPU at {agree}')
        print(f'tiny {kind} f32 int8-cache greedy codes: card equal to CPU '
              f'({[tuple(c.shape) for c in codes[0]]})')
    for kind in ('hq-transformer/bidirectional4', 'hq-transformer'):
        cfg = build_twostage_config(str(TINY))
        cfg.stage2.type = kind
        models = {dev: TwoStageModel(cfg, torch.bfloat16, device=dev)
                  for dev in ('cpu', 'cuda')}
        weights = {s: serving_bf16_params(w)
                   for s, w in models['cpu'].init_weights(9).items()}
        scales = models['cpu'].calibrate_kv_scales(
            weights, torch.Generator().manual_seed(1), labels, greedy)
        ct = torch.randint(0, 256, (8, 16), generator=g)
        cells = torch.randint(0, 256, (8, 16, 4), generator=g)
        scales.update(models['cpu'].calibrate_stage2_int8(
            weights, ct, cells_to_raster(cells, 4, 2).reshape(8, -1),
            labels))
        logits = []
        for dev, m in models.items():
            m.load_weights(weights)
            logits.append(forced_depth_logits(
                m.stage2, labels.to(dev), ct.to(dev), cells.to(dev),
                INT8MAX, scales).cpu())
        ref, out = logits
        top1 = float((ref.argmax(-1) == out.argmax(-1)).float().mean())
        err = float((out - ref).abs().max())
        require(bool(torch.isfinite(out).all()) and top1 >= 0.9,
                f'tiny {kind} int8max teacher-forced depth logits: top-1 '
                f'agreement card/CPU {top1:.2%}, max|d| {err:.3f}')
        print(f'tiny {kind} int8max teacher-forced depth logits '
              f'{tuple(out.shape)}: top-1 card = CPU at {top1:.2%}, '
              f'max|card - cpu| {err:.4f} (logits up to '
              f'{float(ref.abs().max()):.2f})')


def run_serving_rest(da, st, q8):
    """Phase 13. Returns the `decode_attention_int8_t320` JSON row's
    numbers: (Transformer1d's int8 K1 launches, max |y - plain| / 127,
    the times at pos 191)."""
    t0 = time.perf_counter()
    err = check_k1_int8_flat(da)
    times = time_k1_int8_flat(da)
    run_int8_depth_modes(da, st, q8)
    launches = run_int8_flat(da, st, q8)
    run_clis()
    print(f'phase 13 (int8 serving of every sampler, the CLIs): '
          f'{time.perf_counter() - t0:.1f} s')
    return launches, err, times[191]


# ------------- phase 14: the data pipeline, FID-Inception, the eval CLIs

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
PNG_COLOUR = {'L': 0, 'RGB': 2, 'P': 3, 'LA': 4, 'RGBA': 6}


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    import zlib
    return (len(body).to_bytes(4, 'big') + kind + body +
            (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, 'big'))


def encode_png(array, mode: str, filters, palette=None, bits: int = 8,
               trns: bytes = None) -> bytes:
    """The bytes of a PNG file (zlib and struct only) of uint8 `array`
    ([H, W] or [H, W, bands]) in `mode` ('L', 'LA', 'RGB', 'RGBA', or 'P'
    with `palette` [n, 3] at `bits` 1, 2, 4 or 8): row r filtered with
    filter type filters[r % len(filters)] (0 None, 1 Sub, 2 Up, 3
    Average, 4 Paeth); `trns` is a tRNS chunk's body."""
    import struct
    import zlib

    import numpy as np

    arr = np.asarray(array, np.uint8)
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1).astype(np.int32)
    if bits < 8:
        per_byte = 8 // bits
        padded = np.zeros((h, -(-w // per_byte) * per_byte), np.int32)
        padded[:, :w] = rows
        shifts = 8 - bits * (np.arange(per_byte) + 1)
        rows = (padded.reshape(h, -1, per_byte) << shifts).sum(-1)
    bpp = max(1, rows.shape[1] // w if bits == 8 else 1)
    # every row's raw neighbours are known, so all rows filter at once
    a = np.pad(rows, ((0, 0), (bpp, 0)))[:, :-bpp]        # left
    b = np.pad(rows, ((1, 0), (0, 0)))[:-1]               # up
    c = np.pad(b, ((0, 0), (bpp, 0)))[:, :-bpp]           # up-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kinds = np.asarray([filters[r % len(filters)] for r in range(h)])
    pred = np.choose(kinds[:, None], [np.zeros_like(rows), a, b,
                                      (a + b) >> 1, paeth])
    data = np.concatenate([kinds[:, None], (rows - pred) & 0xFF],
                          1).astype(np.uint8).tobytes()
    out = PNG_SIGNATURE + _png_chunk(b'IHDR', struct.pack(
        '>IIBBBBB', w, h, bits, PNG_COLOUR[mode], 0, 0, 0))
    if palette is not None:
        out += _png_chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _png_chunk(b'tRNS', trns)
    return (out + _png_chunk(b'IDAT', zlib.compress(data, 1)) +
            _png_chunk(b'IEND', b''))


SMOKE_EVAL = ROOT / 'build' / 'smoke_eval'
STAGE1_FLAGSHIP = ROOT / 'configs/imagenet/stage1/' \
    'hqvae-pixelshuffle-top8x8.yaml'
# ImageNet-like sizes (w, h) and the tree's size: two batches of 128
EVAL_SIZES = ((256, 256), (320, 240), (500, 375), (375, 500), (200, 300))
EVAL_IMAGES = 256


def eval_image(k: int, rng):
    """Image k of the tree: smooth colour waves plus noise at one of
    EVAL_SIZES; RGB but for every 16 images one each of L, P, RGBA and
    LA. -> (array, mode, palette)."""
    import numpy as np

    w, h = EVAL_SIZES[k % len(EVAL_SIZES)]
    x, y = np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)
    phase = rng.rand(3) * 6.283
    waves = []
    for c in range(3):      # sin(u + v) = sin u cos v + cos u sin v
        u, v = x / (17 + 9 * c) + phase[c], y / (23 + 5 * c)
        waves.append(127 + 100 * (np.outer(np.cos(v), np.sin(u)) +
                                  np.outer(np.sin(v), np.cos(u))))
    rgb = np.clip(np.stack(waves, -1) + rng.randint(-12, 13, (h, w, 3)), 0,
                  255).astype(np.uint8)
    alpha = np.broadcast_to((np.arange(w) * 255 // max(w - 1, 1)).astype(
        np.uint8), (h, w))
    kind = k % 16
    if kind == 1:
        return rgb.mean(-1).astype(np.uint8), 'L', None
    if kind == 5:
        return rgb[..., 0], 'P', rng.randint(0, 256, (256, 3))
    if kind == 9:
        return np.concatenate([rgb, alpha[..., None]], -1), 'RGBA', None
    if kind == 13:
        return np.stack([rgb[..., 1], alpha], -1), 'LA', None
    return rgb, 'RGB', None


def write_eval_tree():
    """EVAL_IMAGES PNGs under build/smoke_eval/val/class<0..3>/, each row
    filter type on some rows of every file."""
    import numpy as np

    shutil.rmtree(SMOKE_EVAL, ignore_errors=True)
    rng = np.random.RandomState(14)
    t0 = time.perf_counter()
    for k in range(EVAL_IMAGES):
        arr, mode, palette = eval_image(k, rng)
        filters = [0, 1, 2, 3, 4] + list(rng.randint(0, 5, arr.shape[0]))
        path = SMOKE_EVAL / 'val' / f'class{k % 4}' / f'{k:04d}.png'
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(encode_png(arr, mode, filters, palette))
    print(f'wrote {EVAL_IMAGES} PNGs (sizes {EVAL_SIZES}; RGB, L, P, RGBA, '
          f'LA) in {time.perf_counter() - t0:.1f} s')


def time_loader():
    """The loader alone on the tree: the decoder it took, ms an image of
    decode and of the valid transform (one thread), images/s of the
    valid loader at batch 128 with 8 workers; where Pillow took it, the
    port's PNG decoder too (arrays equal to Pillow's); two train passes
    with one seed giving equal arrays. Returns the valid batches."""
    import numpy as np

    from hqtransformer_tpu_torch.data import datasets
    from hqtransformer_tpu_torch.data import transforms as T

    ds = datasets.build_dataset('imagenet', str(SMOKE_EVAL), 'val')
    require(len(ds) == EVAL_IMAGES, f'tree holds {len(ds)} images')
    loader = datasets.DataLoader(ds, datasets.LoaderConfig(
        batch_size=B, resolution=256, train=False, num_workers=8))
    print(f'loader: {loader!r}')
    n = min(40, len(ds))
    t0 = time.perf_counter()
    images = [datasets.load_image(ds.samples[i][0]) for i in range(n)]
    decode_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for im in images:
        T.valid_transform(im, 256)
    resize_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    batches = list(loader)
    seconds = time.perf_counter() - t0
    require([x.shape for x, _ in batches] == [(B, 256, 256, 3)] * 2,
            'valid loader batches')
    print(f'loader: decode {decode_ms:.2f} ms/image, resize + crop + '
          f'normalise {resize_ms:.2f} ms/image (one thread, {n} images of '
          f'every size); valid loader {EVAL_IMAGES / seconds:.2f} images/s '
          f'(batch {B}, 8 workers, {seconds:.2f} s)')
    class First:
        def __init__(self, n):
            self.n = min(n, len(ds))

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return ds[i]

    if datasets._pillow() is not None:
        # the port's own decoder, which hosts without Pillow take, on the
        # first 64 images (batch 16)
        pillow = datasets._pillow
        datasets._pillow = lambda: None
        cfg = datasets.LoaderConfig(batch_size=16, resolution=256,
                                    train=False, num_workers=8)
        try:
            t0 = time.perf_counter()
            for i in range(n):
                datasets.load_image(ds.samples[i][0])
            png_ms = (time.perf_counter() - t0) / n * 1e3
            t0 = time.perf_counter()
            own = np.concatenate([x for x, _ in datasets.DataLoader(
                First(64), cfg)])
            png_seconds = time.perf_counter() - t0
        finally:
            datasets._pillow = pillow
        ref = np.concatenate([x for x, _ in batches])[:len(own)]
        require(len(own) > 0 and (own == ref).all(),
                'the PNG decoder\'s batches differ from Pillow\'s')
        print(f'loader with the port\'s PNG decoder (data/png.py): decode '
              f'{png_ms:.2f} ms/image (one thread); valid loader '
              f'{len(own) / png_seconds:.2f} images/s (batch 16, 8 workers, '
              f'{len(own)} images); arrays equal to Pillow\'s')

    cfg = datasets.LoaderConfig(batch_size=16, resolution=256, seed=3)
    runs = [[x for x, _ in datasets.DataLoader(First(32), cfg)]
            for _ in range(2)]
    require(all((a == b).all() for a, b in zip(*runs)) and len(runs[0]) > 0,
            'two train passes with one seed differ')
    print(f'loader: two train passes (seed 3, {len(First(32))} images) give '
          f'equal arrays')
    return batches


def write_eval_weights():
    """A stage-1 trainer's .ckpt of seeded random f32 weights of the
    flagship stage 1 (generator. keys and a discriminator. entry) and a
    pt_inception-layout .pth of seeded He-scaled weights (with AuxLogits.*
    entries)."""
    from hqtransformer_tpu_torch.config import build_stage1_config
    from hqtransformer_tpu_torch.evaluation.inception import he_scaled_state
    from hqtransformer_tpu_torch.evaluation.stage1 import init_stage1_weights

    cfg = build_stage1_config(str(STAGE1_FLAGSHIP))
    sd = {f'generator.{k}': v.cpu() for k, v in
          init_stage1_weights(cfg.stage1, seed=14).items()}
    sd['discriminator.main.0.weight'] = torch.zeros(64, 3, 4, 4)
    torch.save({'state_dict': sd, 'epoch': 0}, SMOKE_EVAL / 'stage1.ckpt')
    state = he_scaled_state(14)
    state['AuxLogits.conv0.conv.weight'] = torch.zeros(128, 768, 1, 1)
    state['AuxLogits.fc.weight'] = torch.zeros(1000, 768)
    torch.save(state, SMOKE_EVAL / 'pt_inception.pth')


def captured_main(main, argv):
    """main(argv) in this process with its stdout captured and echoed:
    (return code, stdout)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for ln in out.splitlines():
        print(f'  {ln}')
    return rc, out


def run_eval_stage1(vq, da, st):
    """cli.eval_stage1 on the tree with --fid --code-usage --top-only at
    batch 128, in this process (launch counters read: exactly 8 K3, 2
    levels x 2 batches x 2 passes, no K1 or K2) and then as a
    subprocess. Returns the K3 launches."""
    from hqtransformer_tpu_torch.cli import eval_stage1

    argv = ['-c', str(STAGE1_FLAGSHIP), '-m', str(SMOKE_EVAL / 'stage1.ckpt'),
            '--data-root', str(SMOKE_EVAL), '--batch-size', str(B), '--fid',
            '--code-usage', '--top-only', '--inception-weights',
            str(SMOKE_EVAL / 'pt_inception.pth')]
    reset_counts('k3.launches', 'k1.launches', 'k2.launches')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc, out = captured_main(eval_stage1.main, argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts(vq, da, st)
    require(rc == 0 and counts == (8, 0, 0),
            f'eval_stage1: rc {rc}, launches (K3, K1, K2) {counts}')
    mse = re.search(r'^MSE: (\S+) over (\d+) images', out, re.M)
    top = re.search(r'^MSE \(top-only recon\): (\S+)', out, re.M)
    usage = [float(u) / 100 for u in
             re.findall(r'^level \d+: (\S+)% of', out, re.M)]
    rfid = re.search(r'^rFID: (\S+)', out, re.M)
    require(mse and int(mse.group(2)) == EVAL_IMAGES and
            math.isfinite(float(mse.group(1))) and top and
            math.isfinite(float(top.group(1))), f'eval_stage1 MSE: {out}')
    require(len(usage) == 2 and all(0 < u <= 1 for u in usage),
            f'eval_stage1 code usage {usage}')
    require(rfid and math.isfinite(float(rfid.group(1))) and
            float(rfid.group(1)) >= 0, f'eval_stage1 rFID: {out}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'cli.eval_stage1 in this process: {counts[0]} K3 launches, no '
          f'K1 or K2; {seconds:.1f} s wall, {EVAL_IMAGES / seconds:.2f} '
          f'images/s (data, f32 reconstruction, top-only reconstruction, '
          f'Inception, rFID), peak {peak:.2f} GiB')
    torch.cuda.empty_cache()
    out = run_cli(argv, 'eval_stage1')
    print('  ' + out.strip().splitlines()[-1])
    return counts[0]


def conv_macs(model, x):
    """Multiply-adds of the convolutions and the fc of one forward."""
    macs = []

    def hook(module, inputs, output):
        if isinstance(module, torch.nn.Conv2d):
            kh, kw = module.kernel_size
            macs.append(output.numel() * module.in_channels * kh * kw)
        elif isinstance(module, torch.nn.Linear):
            macs.append(output.numel() * module.in_features)
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.inference_mode():
            model(x, return_logits=True)
    finally:
        for h in handles:
            h.remove()
    return sum(macs)


def time_inception():
    """FID-Inception alone, f32 (TF32 off), batch 128 of 256^2 inputs:
    images/s, peak memory and the f32 bound; its features of 4 images
    against a CPU run of the same weights (rtol 1e-4, atol 1e-4, std >
    1e-2)."""
    from hqtransformer_tpu_torch.evaluation.fid import InceptionExtractor
    from hqtransformer_tpu_torch.evaluation.inception import (
        FIDInceptionV3, load_pt_inception)

    weights = str(SMOKE_EVAL / 'pt_inception.pth')
    ext = InceptionExtractor(weights, batch_size=B)
    g = torch.Generator(device='cuda').manual_seed(14)
    x = torch.rand(B, 256, 256, 3, generator=g, device='cuda')
    macs = conv_macs(ext.model, x[:1])
    with torch.inference_mode():
        ext.model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(3):
            ext.model(x)
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 3
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    bound_ms = 2 * macs * B / F32_FLOPS_PER_S * 1e3
    print(f'FID-Inception f32, batch {B}, 256^2 -> 299^2: {ms:.3f} ms a '
          f'batch, {B / ms * 1e3:.2f} images/s, peak {peak:.1f} MiB; '
          f'{macs / 1e9:.3f} G multiply-adds an image, bound {bound_ms:.3f} '
          f'ms a batch at 67 TFLOP/s f32 ({bound_ms / ms:.1%} of it)')
    cpu = FIDInceptionV3().eval()
    load_pt_inception(cpu, torch.load(weights, weights_only=True))
    with torch.inference_mode():
        ref = cpu(x[:4].cpu())
    card = torch.from_numpy(ext.features(x[:4]))
    err = float((card - ref).abs().max())
    require(torch.allclose(card, ref, rtol=1e-4, atol=1e-4) and
            float(ref.std()) > 1e-2,
            f'Inception card vs CPU: max |diff| {err}, std {ref.std()}')
    print(f'FID-Inception card = CPU on 4 images: max |diff| {err:.2e} '
          f'(features std {float(ref.std()):.4f})')


def run_fid_clis(batches):
    """cli.compute_fid_stats over the tree (--save-acts), then
    cli.eval_hqmodel on phase 13's samples against it: FID finite,
    precision, recall and coverage in [0, 1], acts.npz written; a second
    call served from acts.npz with no Inception forward; pixel features
    (their reference from the valid loader's batches) give a finite FID;
    the first call's frechet_distance at 2048 dimensions timed on the
    host."""
    import ast

    import numpy as np

    from hqtransformer_tpu_torch.cli import eval_hqmodel
    from hqtransformer_tpu_torch.evaluation import fid
    from hqtransformer_tpu_torch.evaluation.inception import FIDInceptionV3

    weights = str(SMOKE_EVAL / 'pt_inception.pth')
    stats = SMOKE_EVAL / 'stats.npz'
    run_cli(['-d', 'imagenet', '--data-root', str(SMOKE_EVAL), '--split',
             'val', '-o', str(stats), '--save-acts', '--batch-size', str(B),
             '--inception-weights', weights], 'compute_fid_stats')
    ref = np.load(stats)
    require(ref['acts'].shape == (EVAL_IMAGES, 2048) and
            np.isfinite(ref['sigma']).all(), 'compute_fid_stats npz')
    pixels = SMOKE_EVAL / 'pixel_stats.npz'
    feats = fid.PixelExtractor().features(
        np.concatenate([x for x, _ in batches]) * 0.5 + 0.5)
    np.savez(pixels, **dict(zip(('mu', 'sigma'),
                                fid.mean_covar_numpy(feats))))

    forwards, fid_seconds = [0], []
    original, frechet = FIDInceptionV3.forward, eval_hqmodel.frechet_distance

    def counted(self, *args, **kwargs):
        forwards[0] += 1
        return original(self, *args, **kwargs)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = frechet(*args, **kwargs)
        fid_seconds.append(time.perf_counter() - t0)
        return out

    FIDInceptionV3.forward = counted
    eval_hqmodel.frechet_distance = timed
    try:
        t0 = time.perf_counter()
        rc, out = captured_main(eval_hqmodel.main, [
            '-r', str(SMOKE_SAMPLES), '--ref-stat-path', str(stats),
            '--ref-feature-path', str(stats), '--inception-weights',
            weights])
        first = ast.literal_eval(out.strip().splitlines()[-1])
        seconds = time.perf_counter() - t0
        require(rc == 0 and math.isfinite(first['fid']) and
                all(0 <= first[k] <= 1
                    for k in ('precision', 'recall', 'coverage')) and
                (SMOKE_SAMPLES / 'acts.npz').exists() and forwards[0] > 0,
                f'eval_hqmodel: {first}, {forwards[0]} Inception forwards')
        print(f'cli.eval_hqmodel: {seconds:.1f} s wall, {forwards[0]} '
              f'Inception forwards, acts.npz written; frechet_distance at '
              f'2048 dimensions (256 samples a side) {fid_seconds[0]:.2f} s '
              f'on the host')
        before = forwards[0]
        rc, out = captured_main(eval_hqmodel.main, [
            '-r', str(SMOKE_SAMPLES), '--ref-feature-path', str(stats)])
        second = ast.literal_eval(out.strip().splitlines()[-1])
        require(rc == 0 and forwards[0] == before and
                all(second[k] == first[k] for k in second),
                f'eval_hqmodel from acts.npz: {second}, '
                f'{forwards[0] - before} Inception forwards')
        print('cli.eval_hqmodel second call: served from acts.npz, no '
              'Inception forward, the same PRDC')
    finally:
        FIDInceptionV3.forward = original
        eval_hqmodel.frechet_distance = frechet
    rc, out = captured_main(eval_hqmodel.main, [
        '-r', str(SMOKE_SAMPLES), '--feature-extractor', 'pixels',
        '--ref-stat-path', str(pixels), '-m', 'fid'])
    pixel_fid = ast.literal_eval(out.strip().splitlines()[-1])['fid']
    require(rc == 0 and math.isfinite(pixel_fid), f'pixel FID {pixel_fid}')
    print(f'cli.eval_hqmodel --feature-extractor pixels: FID {pixel_fid}')


def run_eval_pipeline(vq, da, st):
    """Phase 14. Returns the K3 launches of the eval_stage1 run."""
    t0 = time.perf_counter()
    write_eval_tree()
    batches = time_loader()
    write_eval_weights()
    k3 = run_eval_stage1(vq, da, st)
    time_inception()
    run_fid_clis(batches)
    print(f'phase 14 (the data pipeline, FID-Inception, the evaluation '
          f'CLIs): {time.perf_counter() - t0:.1f} s')
    return k3


# ------------------------------------------------- phase 15: stage-2 training

SMOKE_TRAIN = ROOT / 'build' / 'smoke_train'
LEVEL3_S2 = ROOT / 'configs/imagenet/stage2/hqtransformer-l12-top8x8-level3.yaml'
TINY_S1 = ROOT / 'configs/tiny/stage1-tiny.yaml'
B_TRAIN2, B_TRAIN1 = 64, 16
TRAIN_WARMUP, TRAIN_STEPS2, TRAIN_STEPS1 = 2, 10, 5
# K3 on the training paths, (N, D) per level: the frozen stage 1 of
# stage-2 training at batch 64, and stage-1 training at batch 16.
K3_TRAIN = {'stage2': ((B_TRAIN2 * 64, 1024), (B_TRAIN2 * 256, 256)),
            'stage1': ((B_TRAIN1 * 64, 1024), (B_TRAIN1 * 256, 256))}


def train_batches(n: int, batch: int, seed: int, n_classes: int = 1000):
    """n seeded batches of images [batch, 256, 256, 3] in [-1, 1] and class
    labels on the card."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    return [(torch.rand((batch, 256, 256, 3), generator=g, device='cuda') *
             2 - 1, torch.randint(0, n_classes, (batch,), generator=g,
                                  device='cuda')) for _ in range(n)]


def training_model(path, dtype, seed, device='cuda', draw_on=None):
    """(config, TwoStageModel) of a stage-2 config with seeded random f32
    weights (drawn on `draw_on`, by default the model's device) loaded
    once; stage 1 frozen."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.models.twostage import TwoStageModel

    cfg = build_twostage_config(str(path))
    model = TwoStageModel(cfg, dtype, device=device)
    drawer = TwoStageModel(cfg, device=draw_on) if draw_on else model
    model.load_weights(drawer.init_weights(seed))
    model.stage1.requires_grad_(False)
    return cfg, model


def stage2_trainer(cfg, model, schedule=None, layout=None):
    """(train_step, state, optimizer) on the config's optimizer, one
    micro-step an update (under `layout`'s dp and tp groups, if given)."""
    from hqtransformer_tpu_torch.train import stage2 as ts
    from hqtransformer_tpu_torch.train.scheduler import \
        build_schedule_from_config

    if schedule is None:
        schedule = build_schedule_from_config(cfg.optimizer, 1000, 100000,
                                              world_size=1)
    opt = ts.make_optimizer(cfg.optimizer, schedule,
                            mask=ts.decay_mask(model.stage2))
    s2 = cfg.stage2
    step = ts.make_train_step(
        model.stage2, model.stage1, opt, layout=layout,
        weight_bottom=s2.weight_bottom or 4.0,
        weight_img=s2.weight_img, weight_txt=s2.weight_txt,
        temp_soft_labels=s2.temp_soft_labels,
        use_cond=bool(s2.use_cls_cond or s2.use_txt_cond),
        multilevel='multilevel-hq' in s2.type)
    return step, ts.init_train_state(model.stage2, opt), opt


def time_training(name, step, state, batches, kernels, k3_per_step, n_steps,
                  batch, loss_key='loss', rng=None, gn_per_step=0):
    """TRAIN_WARMUP steps, then n_steps timed (host clock around them,
    ending in a synchronisation) with the launch counters set to 0 just
    before: exactly k3_per_step K3 launches a step and no K1 or K2,
    gn_per_step GroupNorm kernel pairs a step (the GroupNorms that run
    outside autograd) and no layout copy, finite losses. Returns (state,
    ms a step, K3 launches)."""
    vq, da, st = kernels
    extra = () if rng is None else (rng,)

    def args(i):
        x, y = batches[i % len(batches)]
        return (x,) + extra if rng is not None else (x, y)
    for i in range(TRAIN_WARMUP):
        state, _ = step(state, *args(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts('k3.launches', 'k1.launches', 'k2.launches', 'gn.launches',
                 'gn.layout_copies')
    losses = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, m = step(state, *args(TRAIN_WARMUP + i))
        losses.append(m[loss_key])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    counts = launch_counts(vq, da, st)
    losses = [float(v) for v in losses]
    require(counts == (k3_per_step * n_steps, 0, 0),
            f'{name}: launches (K3, K1, K2) {counts} in {n_steps} steps, '
            f'not {k3_per_step} K3 a step')
    gn = (since_reset('gn.launches'), since_reset('gn.layout_copies'))
    require(gn == (gn_per_step * n_steps, 0), f'{name}: GroupNorm kernel '
            f'pairs, layout copies {gn} in {n_steps} steps, not '
            f'{gn_per_step} a step and no copy')
    require(all(math.isfinite(v) for v in losses), f'{name}: losses {losses}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'{name}: {ms:.1f} ms a step, {batch / ms * 1e3:.2f} images/s at '
          f'batch {batch} ({n_steps} steps after {TRAIN_WARMUP}), '
          f'{counts[0] // n_steps} K3 launches a step, no K1 or K2, '
          f'{gn_per_step} GroupNorm kernels a step, peak {peak:.2f} GiB; '
          f'{loss_key} {losses[0]:.4f} .. {losses[-1]:.4f}')
    return state, ms, counts[0]


def global_norm(grads) -> float:
    return float(torch.sqrt(sum((g.float() ** 2).sum()
                                for g in grads.values())))


def time_k3_training(vq, shapes, z_dtype, e_dtype, label):
    """K3 at a training path's (N, D) levels, z in z_dtype and the EMA
    codebook in e_dtype: codes against the plain version's (the near-tie
    rule), then kernel, plain and addmm+argmin times and the bound, as
    `time_vq_argmin` takes them. Returns the JSON fields (ms, plain,
    library, (bound, by)) as the mean of one launch a level, and the
    largest f64 gap of a differing row."""
    rows, max_err = [], 0.0
    pairs = pair_list(vq, z_dtype, e_dtype)
    for N, D in shapes:
        g = torch.Generator(device='cuda').manual_seed(N + D + 15)
        z = torch.randn((N, D), generator=g, device='cuda').to(z_dtype)
        e = torch.randn((N_CODES, D), generator=g, device='cuda').to(e_dtype)
        n_diff, err = compare_codes(z, e, vq.vq_argmin(z, e),
                                    vq.vq_argmin_plain(z, e))
        max_err = max(max_err, err)
        ms = time_ms(lambda i: vq.vq_argmin(z, e), 5)
        plain = time_ms(lambda i: vq.vq_argmin_plain(z, e), 3)
        ef = e.float()
        lib = time_ms(lambda i: torch.addmm(ef.square().sum(1), z.float(),
                                            ef.T, alpha=-2).argmin(1), 5)
        n_bytes = N * D * z.element_size() + N_CODES * D * e.element_size() \
            + N * 8
        bnd = bound(n_bytes, 2 * N * N_CODES * D, BF16_FLOPS_PER_S)
        rows.append((ms, plain, lib, bnd))
        print(f'K3 {label} N={N} D={D} {str(z_dtype)[6:]} z, '
              f'{str(e_dtype)[6:]} codebook ({pairs}): {n_diff} of {N} rows '
              f'differ from plain, each a near-tie; kernel {ms:.4f} ms, plain '
              f'{plain:.4f} ms, addmm+argmin {lib:.4f} ms, bound '
              f'{bnd[0]:.4f} ms ({bnd[1]}; kernel {ms / bnd[0]:.2f}x)')
        del z, e, ef
    mean = tuple(sum(r[i] for r in rows) / len(rows) for i in range(3))
    return mean + ((sum(r[3][0] for r in rows) / len(rows), rows[0][3][1]),
                   ), max_err


def param_diffs(a, b):
    """|a - b| over every entry of parameter dicts a and b (on the CPU)."""
    require(set(a) == set(b), 'the parameter names differ')
    return torch.cat([(a[k].detach().cpu() - b[k].detach().cpu()).abs()
                      .reshape(-1) for k in b])


def check_stage2_training_tiny():
    """configs/tiny/stage2-tiny.yaml, 3 f32 steps on the card and on the
    CPU from the same weights and batches (clipping active, warmup lr to
    1e-3): the parameters' median difference under 1e-7, 99% within 1e-6
    and all within 2e-4 (Adam makes a near-zero gradient's rounding a
    whole update: see tests/test_torch_train_stage1.py)."""
    import numpy as np

    from hqtransformer_tpu_torch.train.scheduler import build_schedule

    out = {}
    for device in ('cuda', 'cpu'):
        cfg, model = training_model(TINY, torch.float32, 15, device, 'cpu')
        step, state, _ = stage2_trainer(
            cfg, model, build_schedule(1e-3, 2, 10, warmup_epoch=1.0))
        rng = np.random.RandomState(15)
        for _ in range(3):
            x = torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(
                np.float32)).to(device)
            y = torch.from_numpy(rng.randint(0, 10, (4,))).to(device)
            state, _ = step(state, x, y)
        out[device] = state.params
    diffs = param_diffs(out['cuda'], out['cpu'])
    q = [float(torch.quantile(diffs, p)) for p in (0.5, 0.99, 0.999)]
    worst = float(diffs.max())
    print(f'tiny stage-2 training, 3 f32 steps: card and CPU parameters '
          f'differ by median {q[0]:.2e}, 99% within {q[1]:.2e}, 99.9% '
          f'within {q[2]:.2e}, at most {worst:.2e}')
    require(q[0] < 1e-7 and q[1] <= 1e-6 and worst <= 2e-4,
            'tiny stage-2 training: card and CPU parameters differ')


def write_train_tree():
    """128 train and 32 val PNGs (phase 14's image maker: ImageNet-like
    sizes and modes) under build/smoke_train/data/{train,val}/class<k>/."""
    import numpy as np

    root = SMOKE_TRAIN / 'data'
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.RandomState(15)
    for split, n in (('train', 128), ('val', 32)):
        for k in range(n):
            arr, mode, palette = eval_image(k, rng)
            path = root / split / f'class{k % 4}' / f'{k:04d}.png'
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(encode_png(arr, mode, [0, 1, 2, 3, 4], palette))
    return root


def run_dir(parent):
    (run,) = [p for p in Path(parent).glob('*/*') if p.is_dir()]
    return run


def time_train_loader(root):
    """The train loader alone on the tree at batch 64 (8 workers): images/s
    of the host's part of a stage-2 step."""
    from hqtransformer_tpu_torch.data import datasets

    ds = datasets.build_dataset('imagenet', str(root), 'train')
    cfg = datasets.LoaderConfig(batch_size=B_TRAIN2, resolution=256, seed=1)
    t0 = time.perf_counter()
    n = sum(len(x) for x, _ in datasets.DataLoader(ds, cfg))
    seconds = time.perf_counter() - t0
    print(f'train loader (train transform, 8 workers, batch {B_TRAIN2}): '
          f'{n / seconds:.2f} images/s ({n} images in {seconds:.2f} s)')


def run_stage2_cli(root):
    """cli.main_stage2 on the flagship: --max-steps 4 from a trainer-layout
    stage-1 .ckpt, then --resume to 6 (the step count continues); the
    sampler-ready bundle loads strictly."""
    from hqtransformer_tpu_torch.checkpoint import restore_checkpoint
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.models.twostage import TwoStageModel

    s1 = SMOKE_EVAL / 'stage1.ckpt'
    if not s1.exists():
        SMOKE_EVAL.mkdir(parents=True, exist_ok=True)
        write_eval_weights()
    common = ['-c', str(FLAGSHIP), '--data-root', str(root),
              '--stage1-ckpt', str(s1)]
    for d in ('s2a', 's2b'):
        shutil.rmtree(SMOKE_TRAIN / d, ignore_errors=True)
    run_cli(['-r', str(SMOKE_TRAIN / 's2a'), '--max-steps', '4', *common],
            'main_stage2')
    first = run_dir(SMOKE_TRAIN / 's2a')
    run_cli(['-r', str(SMOKE_TRAIN / 's2b'), '--max-steps', '6', '--resume',
             str(first / 'ckpt'), *common], 'main_stage2')
    second = run_dir(SMOKE_TRAIN / 's2b')
    log = (second / 'train.log').read_text()
    require('resumed from' in log and '@ step 4' in log and
            'final checkpoint saved @ step 6' in log,
            f'cli.main_stage2 --resume: {log[-2000:]}')
    require(restore_checkpoint(str(second / 'ckpt'), 6)['step'] == 6,
            'the resumed run did not save step 6')
    print('  ' + '\n  '.join(ln for ln in log.splitlines()
                             if 'step ' in ln or 'valid' in ln)[:1500])
    bundle = second / 'ckpt_full' / '6.ckpt'
    model = TwoStageModel(build_twostage_config(str(FLAGSHIP)))
    weights = model.load_reference_checkpoint(str(bundle))
    print(f'cli.main_stage2: 4 steps, resumed to 6; {bundle.name} loads '
          f'strictly ({len(weights["stage1"])} + {len(weights["stage2"])} '
          f'tensors)')


def run_stage2_training(vq, da, st):
    """Phase 15. Returns the JSON fields of K3 on the stage-2 training path
    (launches of the timed f32 run, max gap, times)."""
    from hqtransformer_tpu_torch.train.optim import grads_of

    t0 = time.perf_counter()
    kernels = (vq, da, st)
    batches = train_batches(4, B_TRAIN2, 150)
    results = {}
    cfg, model = training_model(FLAGSHIP, torch.float32, 15)
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16:
            weights = {s: dict(getattr(model, s).state_dict())
                       for s in ('stage1', 'stage2')}
            del model
            torch.cuda.empty_cache()
            cfg, model = training_model(FLAGSHIP, dtype, 15)
            model.load_weights(weights)
            del weights
        step, state, opt = stage2_trainer(cfg, model)
        name = f'stage-2 training {str(dtype)[6:]}'
        # the frozen stage 1 encodes outside autograd: the kernel at each
        # of its encoder's GroupNorms
        state, ms, k3 = time_training(
            name, step, state, batches, kernels, 2, TRAIN_STEPS2, B_TRAIN2,
            gn_per_step=gn_count(model.stage1, 'encoder'))
        x, y = batches[0]
        loss, _ = step.loss_fn(x, y)
        norm = global_norm(grads_of(loss, state.params))
        require(math.isfinite(norm), f'{name}: gradient norm {norm}')
        print(f'{name}: gradient norm {norm:.4f} (finite)')
        results[dtype] = (ms, k3)
        if dtype == torch.float32:
            profile_stage2_step(step, state, batches[0], model.stage1, opt)
        del step, state, opt, loss
        torch.cuda.empty_cache()
    # one repeated batch at a constant lr: the loss falls
    step, state, _ = stage2_trainer(cfg, model, lambda t: 1e-4)
    x, y = batches[1]
    losses = []
    for _ in range(10):
        state, m = step(state, x, y)
        losses.append(float(m['loss']))
    require(losses[-1] < losses[0], f'the loss did not fall: {losses}')
    print(f'stage-2 training bf16, one batch repeated at lr 1e-4: loss '
          f'{losses[0]:.4f} -> {losses[-1]:.4f} over 10 steps')
    del step, state, model
    torch.cuda.empty_cache()
    check_remat()
    for path, batch, k3 in ((LEVEL3_S2, 32, 3), (SOFT_S2, 16, 0)):
        one_step(path, batch, k3, kernels)
    check_stage2_training_tiny()
    root = write_train_tree()
    time_train_loader(root)
    run_stage2_cli(root)
    fields, err = time_k3_training(vq, K3_TRAIN['stage2'], torch.float32,
                                   torch.float32, 'stage-2 training')
    time_k3_training(vq, K3_TRAIN['stage2'], torch.bfloat16, torch.float32,
                     'stage-2 training (bf16 activations)')
    print(f'phase 15 (stage-2 training): {time.perf_counter() - t0:.1f} s')
    return results[torch.float32][1], err, fields


def profile_stage2_step(step, state, batch, stage1, opt):
    """Where a flagship f32 step's time goes: the frozen stage 1's codes
    alone, the step's forward and backward (codes included), the
    optimizer's update, each timed alone and profiled."""
    from hqtransformer_tpu_torch.train import stage2 as ts
    from hqtransformer_tpu_torch.train.optim import grads_of

    x, y = batch
    grads = {}

    def fwd_bwd():
        loss, _ = step.loss_fn(x, y)
        grads.update(grads_of(loss, state.params))

    fwd_bwd()
    profile_phases((
        ('stage-2 step: stage-1 codes (2 K3)',
         lambda: ts.stage1_codes(stage1, x)),
        ('stage-2 step: forward and backward (codes included)', fwd_bwd),
        ('stage-2 step: optimizer (clip, AdamW)',
         lambda: opt.update(grads, state.opt_state, state.params))))


def check_remat():
    """The flagship's gradients on one batch of 16, with and without
    `remat` (the main blocks recomputed in the backward pass): within
    1e-6."""
    from hqtransformer_tpu_torch.train.optim import grads_of

    cfg, model = training_model(FLAGSHIP, torch.float32, 16)
    step, state, _ = stage2_trainer(cfg, model)
    x, y = train_batches(1, 16, 160)[0]
    grads = []
    for remat in (False, True):
        model.stage2.remat = remat
        torch.cuda.reset_peak_memory_stats()
        loss, _ = step.loss_fn(x, y)
        grads.append(grads_of(loss, state.params))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f'flagship f32 loss and gradients at batch 16, remat '
              f'{remat}: peak {peak:.2f} GiB')
    worst = max(float((grads[0][k] - grads[1][k]).abs().max())
                for k in grads[0])
    require(worst <= 1e-6, f'remat gradients differ by {worst}')
    print(f'remat: gradients within {worst:.2e} of the plain run (bound '
          f'1e-6)')


def one_step(path, batch, k3, kernels):
    """One checked, untimed step of a stage-2 config at `batch`: exactly k3
    K3 launches, no K1 or K2, a finite loss."""
    vq, da, st = kernels
    cfg, model = training_model(path, torch.float32, 17)
    step, state, _ = stage2_trainer(cfg, model)
    x, y = train_batches(1, batch, 170)[0]
    reset_counts('k3.launches', 'k1.launches', 'k2.launches')
    state, m = step(state, x, y)
    torch.cuda.synchronize()
    counts = launch_counts(vq, da, st)
    require(counts == (k3, 0, 0) and math.isfinite(float(m['loss'])),
            f'{path.name}: launches (K3, K1, K2) {counts}, loss '
            f'{float(m["loss"])}')
    print(f'stage-2 training step {path.name} at batch {batch}: {k3} K3 '
          f'launches, no K1 or K2, loss {float(m["loss"]):.4f}')
    del model, step, state
    torch.cuda.empty_cache()


# ------------------------------------------------- phase 16: stage-1 training

def stage1_trainer(cfg, dtype, seed, fast=False, lpips=True, device='cuda'):
    """(train_step, state, generator) of a stage-1 config with seeded
    random weights: the generator, the discriminator, LPIPS on seeded
    He-scaled random VGG16 weights (or none), Adam from the config, one
    micro-step an update."""
    from hqtransformer_tpu_torch.evaluation.stage1 import init_stage1_weights
    from hqtransformer_tpu_torch.models.stage1.generator import \
        build_generator
    from hqtransformer_tpu_torch.models.stage1.lpips import init_lpips
    from hqtransformer_tpu_torch.train import stage1 as t1
    from hqtransformer_tpu_torch.train.scheduler import \
        build_schedule_from_config

    with torch.device('meta'):
        generator = build_generator(cfg.stage1, dtype)
    generator = generator.to_empty(device=device)
    generator.load_state_dict(init_stage1_weights(cfg.stage1, seed, 'cpu'))
    hd = cfg.stage1.hparams_disc
    disc = t1.init_discriminator(t1.make_discriminator(hd, dtype), seed + 1,
                                 device)
    lp = init_lpips(seed, dtype, device) if lpips else None
    sched = build_schedule_from_config(cfg.optimizer, 1000, 100000)
    g_opt, d_opt = (t1.make_stage1_optimizer(cfg.optimizer, sched)
                    for _ in range(2))
    step = t1.make_stage1_train_step(
        generator, disc, lp, g_opt, d_opt, hd,
        residual_l1_weight=hd.residual_l1_weight or 0.0,
        perceptual_weight=1.0 if lpips else 0.0,
        faithful_double_forward=not fast)
    return step, t1.init_stage1_state(generator, disc, g_opt, d_opt), \
        generator


def check_stage1_training_tiny():
    """configs/tiny/stage1-tiny.yaml, 2 f32 steps (no restarts, no LPIPS)
    on the card and on the CPU from the same weights and images, the
    tests' bounds: parameters' median difference under 2e-6 and 99%
    within 1e-4; EMA counts within 1e-6, codebooks rtol 1e-2, atol 1e-3."""
    import numpy as np

    from hqtransformer_tpu_torch.config import build_stage1_config

    cfg = build_stage1_config(str(TINY_S1))
    out = {}
    for device in ('cuda', 'cpu'):
        step, state, _ = stage1_trainer(cfg, torch.float32, 16, lpips=False,
                                        device=device)
        rng = np.random.RandomState(16)
        for _ in range(2):
            x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            state, _ = step(state, torch.from_numpy(x).to(device))
        out[device] = state
    a, b = out['cuda'], out['cpu']
    diffs = param_diffs({**a.gen_params, **a.disc_params},
                        {**b.gen_params, **b.disc_params})
    median, p99 = (float(torch.quantile(diffs, q)) for q in (0.5, 0.99))
    require(median < 2e-6 and p99 <= 1e-4,
            f'tiny stage-1 training: parameters differ by median {median}, '
            f'99% within {p99}')
    for k, v in b.ema.items():
        got = a.ema[k].cpu()
        tol = (1e-6, 0.0) if k.endswith('cluster_size') else (1e-3, 1e-2)
        require(bool(((got - v).abs() <= tol[0] + tol[1] * v.abs()).all()),
                f'tiny stage-1 training: EMA buffer {k} differs')
    print(f'tiny stage-1 training, 2 f32 steps: card and CPU parameters '
          f'differ by median {median:.2e}, 99% within {p99:.2e}; EMA '
          f'buffers within bounds')


def run_stage1_cli(root):
    """cli.main_stage1 on the flagship stage 1 with LPIPS from a
    torchvision-layout VGG16 file of seeded random weights: --max-steps 2,
    then --resume to 3."""
    from hqtransformer_tpu_torch.checkpoint import restore_checkpoint
    from hqtransformer_tpu_torch.models.stage1.lpips import init_lpips

    vgg = SMOKE_TRAIN / 'vgg16.pth'
    sd = init_lpips(16).state_dict()
    torch.save({k.replace('net.conv_', 'features.'): v for k, v in sd.items()
                if k.startswith('net.')}, vgg)
    common = ['-c', str(STAGE1_FLAGSHIP), '--data-root', str(root),
              '--lpips-vgg', str(vgg)]
    for d in ('s1a', 's1b'):
        shutil.rmtree(SMOKE_TRAIN / d, ignore_errors=True)
    run_cli(['-r', str(SMOKE_TRAIN / 's1a'), '--max-steps', '2', *common],
            'main_stage1')
    first = run_dir(SMOKE_TRAIN / 's1a')
    run_cli(['-r', str(SMOKE_TRAIN / 's1b'), '--max-steps', '3', '--resume',
             str(first / 'ckpt'), *common], 'main_stage1')
    second = run_dir(SMOKE_TRAIN / 's1b')
    log = (second / 'train.log').read_text()
    require('resumed from' in log and '@ step 2' in log and
            'final checkpoint saved @ step 3' in log and 'LPIPS weights '
            'loaded' in log, f'cli.main_stage1 --resume: {log[-2000:]}')
    require(restore_checkpoint(str(second / 'ckpt'), 3)['step'] == 3,
            'the resumed run did not save step 3')
    print('  ' + '\n  '.join(ln for ln in log.splitlines()
                             if 'step ' in ln or 'valid' in ln)[:1500])
    print('cli.main_stage1: 2 steps, resumed to 3')


def run_stage1_training(vq, da, st):
    """Phase 16. Returns the JSON fields of K3 on the stage-1 training path
    (launches of the timed faithful run, max gap, times)."""
    from hqtransformer_tpu_torch.config import build_stage1_config

    t0 = time.perf_counter()
    kernels = (vq, da, st)
    cfg = build_stage1_config(str(STAGE1_FLAGSHIP))
    require(cfg.stage1.hparams_disc.disc_start == 0,
            'the flagship stage 1 should train its GAN from step 0')
    batches = train_batches(3, B_TRAIN1, 161)
    rng = torch.Generator(device='cuda').manual_seed(16)
    launches = None
    for fast, k3 in ((False, 4), (True, 2)):
        step, state, generator = stage1_trainer(cfg, torch.float32, 16, fast)
        ema = {k: v.clone() for k, v in state.ema.items()}
        name = f'stage-1 training f32 {"fast" if fast else "faithful"}'
        # the faithful discriminator phase runs the generator again under
        # no_grad: the kernel at each of its GroupNorms; the rest is autograd
        gn_step = 0 if fast else sum(gn_count(generator, part) for part in
                                     ('encoder', 'decoder'))
        state, ms, n = time_training(name, step, state, batches, kernels,
                                     k3, TRAIN_STEPS1, B_TRAIN1,
                                     'total_loss', rng, gn_step)
        state, m = step(state, batches[0][0], rng)
        d_weight = float(m['d_weight'])
        require(math.isfinite(d_weight) and d_weight > 0,
                f'{name}: d_weight {d_weight}')
        moved = sum(not torch.equal(ema[k], v) for k, v in state.ema.items())
        require(moved == len(ema), f'{name}: {moved} of {len(ema)} EMA '
                f'buffers changed')
        print(f'{name}: d_weight {d_weight:.4f}, every EMA buffer changed '
              f'({len(ema)})')
        if not fast:
            launches = n
            profile_phases(((f'{name} step', lambda: step(
                state, batches[1][0], rng)),))
        del step, state
        torch.cuda.empty_cache()
    step, state, _ = stage1_trainer(cfg, torch.bfloat16, 16)
    reset_counts('k3.launches', 'k1.launches', 'k2.launches')
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, batches[0][0], rng)
    torch.cuda.synchronize()
    require(launch_counts(vq, da, st) == (4, 0, 0) and
            math.isfinite(float(m['total_loss'])),
            f'stage-1 bf16 step: launches {launch_counts(vq, da, st)}')
    print(f'stage-1 training bf16, one faithful step: 4 K3 launches, loss '
          f'{float(m["total_loss"]):.4f}, peak '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    del step, state
    torch.cuda.empty_cache()
    check_stage1_training_tiny()
    root = SMOKE_TRAIN / 'data'
    if not root.exists():
        root = write_train_tree()
    run_stage1_cli(root)
    fields, err = time_k3_training(vq, K3_TRAIN['stage1'], torch.float32,
                                   torch.float32, 'stage-1 training')
    print(f'phase 16 (stage-1 training): {time.perf_counter() - t0:.1f} s')
    return launches, err, fields


# ---------------------------------------------- phase 17: tensor parallelism

# The flagship's per-rank attention widths under tensor parallelism:
# (tp, d / tp, heads / tp), head dim 64.
TP_WIDTHS = ((2, 768, 12), (4, 384, 6))
TP_POSITIONS = (1, 33, 63)
TP_WORLD = 4                  # processes on cuda:0, joined by gloo
B_TP_TRAIN = 8                # global training batch: 4 a dp rank at tp 2
N_TP4 = 16                    # spatial positions of the tp-4 sampler call
TP_TRAIN_STEPS = 3
TP_DIR = ROOT / 'build' / 'tp_smoke'
TP_SAMPLER_SEED = 17
# the scorer's bf16 logits at tp 2 against tp 1 on tp 1's codes: the
# bounds of the port's bf16 tests against JAX
TP_LOGIT_STEPS, TP_ARGMAX_AGREEMENT = 4.0, 0.9
# f32 codes at tp 2 x dp 2 against tp 1, first position: at most 3 of the
# 128 rows may differ (f32 sums in another order move a draw only where
# two logits at the top-k edge lie within ~1e-7 relative of each other)
TP_F32_FIRST = 0.97
# int8 serving under tp: K1-int8 at the sharded widths also at the tp-2 x
# dp-2 rank's 64 rows; the f32 int8-cache loop's positions (its check is
# the first position's); the tp-2 calibration on tp 1's draws and codes:
# a short KV run and the activation scales on B_TP_CALIB samples, each
# scale within TP_SCALE_STEPS bf16 steps of tp 1's (the bf16 row-parallel
# sums before it round otherwise)
TP_INT8_BATCHES = (64, B, B_LARGE)
N_TP_F32_INT8 = 16
N_TP_CALIB, B_TP_CALIB = 8, 32
TP_SCALE_STEPS = 4.0


def k1_tp_case(da, dtype, batch, d, n_heads, pos, seed):
    """K1 at one sharded width against its plain version: caches
    bit-equal, y within 1e-5 (f32) / 2e-2 (bf16). Returns max |y - plain|."""
    g = torch.Generator(device='cuda').manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device='cuda').to(dtype)
    kc, vc = randn(2, T, batch, d), randn(2, T, batch, d)
    q, kn, vn = randn(batch, d), randn(batch, d), randn(batch, d)
    kc1, vc1 = kc.clone(), vc.clone()
    layer = pos % 2
    y1 = da.decode_attention_step(q, kn, vn, kc1, vc1, layer, pos, n_heads)
    y2 = da.decode_attention_step_plain(q, kn, vn, kc, vc, layer, pos,
                                        n_heads)
    torch.cuda.synchronize()
    require(torch.equal(kc1, kc) and torch.equal(vc1, vc),
            f'K1 {dtype} cache rows differ at d {d} B {batch} pos {pos}')
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y1.float(), y2.float(), atol=tol, rtol=tol)
    return (y1.float() - y2.float()).abs().max().item()


def check_k1_tp(da):
    """K1 against its plain version at every sharded width (TP_WIDTHS), f32
    and bf16, batch 128 and 1024, pos 1, 33, 63. Returns {tp: max |y -
    plain|} of the bf16 cases."""
    errs = {}
    for tp, d, n_heads in TP_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            for batch in (B, B_LARGE):
                for pos in TP_POSITIONS:
                    err = k1_tp_case(da, dtype, batch, d, n_heads, pos,
                                     seed=pos + d + batch)
                    if dtype == torch.bfloat16:
                        errs[tp] = max(errs.get(tp, 0.0), err)
                    print(f'K1 tp {tp}: {str(dtype)[6:]} d={d} heads='
                          f'{n_heads} B={batch} pos={pos}: caches bit-equal, '
                          f'max|y - plain| = {err:.3e}')
        torch.cuda.empty_cache()
    return errs


def k1_int8_tp_case(da, dtype, batch, d, n_heads, pos, seed):
    """K1's int8 kernel at one sharded width against its plain version:
    int8 caches and new rows over -128..127, an f32 or bf16 q; caches
    bit-equal, y in units of 1/127 within check_decode_attention_int8's
    tolerance. Returns max |y - plain| / 127."""
    g = torch.Generator(device='cuda').manual_seed(seed)

    def randint8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device='cuda',
                             dtype=torch.int8)
    kc, vc = randint8(2, T, batch, d), randint8(2, T, batch, d)
    kn, vn = randint8(batch, d), randint8(batch, d)
    q = (torch.randn((batch, d), generator=g, device='cuda') *
         0.02).to(dtype)
    kc1, vc1 = kc.clone(), vc.clone()
    layer = pos % 2
    y1 = da.decode_attention_step(q, kn, vn, kc1, vc1, layer, pos, n_heads)
    y2 = da.decode_attention_step_plain(q, kn, vn, kc, vc, layer, pos,
                                        n_heads)
    torch.cuda.synchronize()
    require(torch.equal(kc1, kc) and torch.equal(vc1, vc),
            f'K1 int8 cache rows differ at d {d} B {batch} pos {pos}')
    y1, y2 = y1.float() / 127, y2.float() / 127
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y1, y2, atol=tol, rtol=tol)
    return (y1 - y2).abs().max().item()


def check_k1_int8_tp(da):
    """K1's int8 kernel against its plain version at every sharded width
    (TP_WIDTHS), f32 and bf16 q, batch 64, 128 and 1024, pos 1, 33, 63.
    Returns {tp: max |y - plain| / 127 of the bf16 cases}."""
    errs = {}
    for tp, d, n_heads in TP_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            for batch in TP_INT8_BATCHES:
                for pos in TP_POSITIONS:
                    err = k1_int8_tp_case(da, dtype, batch, d, n_heads, pos,
                                          seed=pos + d + batch + 1)
                    if dtype == torch.bfloat16:
                        errs[tp] = max(errs.get(tp, 0.0), err)
                    print(f'K1 int8 tp {tp}: {str(dtype)[6:]} q d={d} heads='
                          f'{n_heads} B={batch} pos={pos}: caches bit-equal, '
                          f'max|y - plain| / 127 = {err:.3e}')
        torch.cuda.empty_cache()
    return errs


def time_k1_int8_shape(da, d, n_heads, label):
    """K1's int8 kernel at pos 33, batch 128, width d (bf16 q) beside its
    plain version and its bytes bound; the calls rotate over enough
    layers to hold K1_ROTATE_BYTES. No PyTorch call attends over an int8
    cache: no library time. Returns (kernel, plain, None, bound)."""
    pos = TIMED_POS
    layer_bytes = 2 * (pos + 1) * B * d
    n_layers = max(4, -(-K1_ROTATE_BYTES // layer_bytes))
    g = torch.Generator(device='cuda').manual_seed(pos + d + 2)
    kc, vc = (torch.randint(-128, 128, (n_layers, T, B, d), generator=g,
                            device='cuda', dtype=torch.int8)
              for _ in range(2))
    kn, vn = (torch.randint(-128, 128, (B, d), generator=g, device='cuda',
                            dtype=torch.int8) for _ in range(2))
    q = (torch.randn((B, d), generator=g, device='cuda') * 0.02).bfloat16()
    kernel = time_ms(lambda i: da.decode_attention_step(
        q, kn, vn, kc, vc, i % n_layers, pos, n_heads), 240)
    plain = time_ms(lambda i: da.decode_attention_step_plain(
        q, kn, vn, kc, vc, i % n_layers, pos, n_heads), 24)
    bnd = bound(k1_bytes(pos, B, True, d), k1_flops(pos, B, d))
    print(f'K1 int8 {label}, bf16 q, pos {pos} B {B} d {d} heads {n_heads}: '
          f'kernel {kernel:.5f} ms, plain {plain:.5f} ms, bound '
          f'{bnd[0]:.5f} ms ({bnd[1]}; kernel {kernel / bnd[0]:.2f}x); no '
          f'library call attends over an int8 cache')
    del kc, vc
    torch.cuda.empty_cache()
    return kernel, plain, None, bnd


def check_collectives(layout):
    """Every collective the port's tensor parallelism uses, on CUDA tensors
    of processes sharing one card: all_reduce over the tp and the dp group
    (f32, and bf16 through `tp.all_reduce`'s f32 sum), the tp group's
    gather of a sharded last dim, the barrier."""
    from hqtransformer_tpu_torch.parallel.tp import all_reduce

    import torch.distributed as dist
    tp = layout.tp_group
    x = torch.full((1024,), float(layout.rank + 1), device='cuda')
    got = all_reduce(x, tp.group)
    members = [r for r in layout.order if layout.order.index(r) // layout.tp
               == layout.dp_rank]
    require(torch.equal(got, torch.full_like(x, float(sum(r + 1 for r in
                                                          members)))),
            f'tp all_reduce gave {got[:4].tolist()}')
    y = all_reduce(x.bfloat16(), layout.dp_group)
    require(y.dtype == torch.bfloat16 and y.is_cuda, 'dp all_reduce dtype')
    require(float(y[0]) == float(sum(r + 1 for r in layout.order[
        layout.tp_rank::layout.tp])), f'dp all_reduce gave {float(y[0])}')
    part = torch.arange(4, device='cuda', dtype=torch.float32) + \
        4 * tp.rank
    full = tp.gather(part[None])
    require(torch.equal(full[0], torch.arange(4 * tp.size, device='cuda',
                                              dtype=torch.float32)),
            f'gather gave {full[0].tolist()}')
    # int8 serving's: the exact int32 sum (values past f32's mantissa)
    # and the max of scales
    big = torch.tensor([2 ** 28 + 7 * (tp.rank + 1)], dtype=torch.int32,
                       device='cuda')
    got = tp.sum_int32(big)
    require(got.dtype == torch.int32 and int(got) == sum(
        2 ** 28 + 7 * (r + 1) for r in range(tp.size)),
        f'tp sum_int32 gave {int(got)}')
    top = tp.max(torch.tensor([float(tp.rank), -float(tp.rank)],
                              device='cuda'))
    require(top.tolist() == [float(tp.size - 1), 0.0], f'tp max gave '
            f'{top.tolist()}')
    layout.barrier()
    require(dist.get_backend() == 'gloo', 'the group is not gloo')
    print(f'rank {layout.rank}: all_reduce (tp, dp; f32, bf16), the int32 '
          f'sum, the max, gather and barrier ran on CUDA tensors over gloo')


def tp_flagship(layout, dtype=torch.bfloat16):
    """The flagship TwoStageModel under `layout` with the seeded random
    weights of every phase-17 call (bf16 serving weights in bf16), its
    128 labels on the card, and its config."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.models.twostage import (TwoStageModel,
                                                         serving_bf16_params)

    cfg = build_twostage_config(str(FLAGSHIP))
    model = TwoStageModel(cfg, dtype=dtype, layout=layout)
    weights = model.init_weights(seed=0)
    if dtype == torch.bfloat16:
        weights = {s: serving_bf16_params(w) for s, w in weights.items()}
    labels = torch.arange(B, device='cuda') % cfg.stage2.hparams.n_classes
    return model, weights, labels


def tp_sampler_call(layout, name, da, st, q8, int8=None, scales=None,
                    tag=''):
    """The flagship sampler (seeded random bf16 weights, top-k 2048, T
    0.95; int8 serving by `int8` and `scales`) under `layout` on the
    whole batch of 128 labels, this rank serving its dp shard: one
    `checked_call` (756 K1 and 128 K2 launches, every K1 on the int8
    kernel and int8 gemms and convs counted with `int8`; codes, pixels);
    then the scorer in the same serving mode on tp 1's codes
    (TP_DIR/ref_codes<tag>.pt), whose logits the first tp rank of each dp
    group writes to TP_DIR/scores<tag><dp rank>.pt. Returns (codes on the
    CPU, seconds, launches)."""
    from hqtransformer_tpu_torch.sampling.engine import (
        SamplingParams, make_hierarchical_scorer)

    int8 = int8 or q8.Int8Serving()
    model, weights, labels = tp_flagship(layout)
    # four processes decode at once: smaller chunks than phase 3's
    sampler = model.make_pixel_sampler(
        params=SamplingParams(**SAMPLING_2048), decode_chunk=32, int8=int8,
        scales=scales)
    gen = torch.Generator(device='cuda').manual_seed(TP_SAMPLER_SEED)
    t0 = time.perf_counter()
    codes, _ = checked_call(model, lambda: sampler(weights, gen, labels),
                            layout.rows(labels), name, da, st, q8,
                            int8=int8.kv_cache, decode_chunk=32)
    seconds = time.perf_counter() - t0
    launches = (since_reset('k1.launches'), since_reset('k2.launches'))
    ref = [c.cuda() for c in torch.load(TP_DIR / f'ref_codes{tag}.pt')]
    t1 = time.perf_counter()
    scores = make_hierarchical_scorer(model.stage2, T, int8, scales)(
        labels, *ref)
    torch.cuda.synchronize()
    print(f'{name}: the scorer on tp 1\'s codes in '
          f'{time.perf_counter() - t1:.3f} s')
    if layout.tp_rank == 0:
        torch.save([x.cpu() for x in scores],
                   TP_DIR / f'scores{tag}{layout.dp_rank}.pt')
    del model, weights, sampler, scores
    torch.cuda.empty_cache()
    return tuple(c.cpu() for c in codes), seconds, launches


def tp_stage2_call(layout, dtype, n, da, st, name, int8=None, scales=None):
    """The flagship's stage-2 sampler (seeded random weights in `dtype`,
    top-k 2048, T 0.95; int8 serving by `int8` and `scales`) under
    `layout` on 128 labels for its first `n` positions (the AR loop
    alone), this rank serving its dp shard: exactly 12 x (n - 1) K1
    launches at the rank's width (all on the int8 kernel with the int8
    cache) and 2 x n K2 launches. Returns (codes on the CPU, seconds,
    launches)."""
    from hqtransformer_tpu_torch.ops.int8 import Int8Serving
    from hqtransformer_tpu_torch.sampling.engine import (
        SamplingParams, make_hierarchical_sampler)

    int8 = int8 or Int8Serving()
    model, weights, labels = tp_flagship(layout, dtype)
    model.load_weights(weights)
    sampler = make_hierarchical_sampler(model.stage2, n,
                                        SamplingParams(**SAMPLING_2048),
                                        int8, scales)
    gen = torch.Generator(device='cuda').manual_seed(TP_SAMPLER_SEED)
    torch.cuda.synchronize()
    reset_counts('k1.launches', 'k2.launches', 'k1.int8_launches')
    with k1_positions() as positions:
        t0 = time.perf_counter()
        codes = sampler(gen, labels)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = (since_reset('k1.launches'), since_reset('k2.launches'))
    k1_int8 = since_reset('k1.int8_launches')
    require(launches == (L * (n - 1), 2 * n) and
            k1_int8 == (launches[0] if int8.kv_cache else 0) and
            (min(positions), max(positions)) == (1, n - 1),
            f'{name}: launches (K1, K2) {launches}, K1 int8 {k1_int8}')
    require(codes[0].shape == (B // layout.dp, n) and
            int(codes[0].max()) < N_CODES and int(codes[1].min()) >= 0,
            f'{name}: codes')
    print(f'{name}, {n} positions, batch {B // layout.dp}: {seconds:.3f} s, '
          f'launches K1={launches[0]} (int8 {k1_int8}; d {D // layout.tp}, '
          f'{NH // layout.tp} heads, pos 1..{n - 1}) K2={launches[1]}')
    del model, weights, sampler
    torch.cuda.empty_cache()
    return tuple(c.cpu() for c in codes), seconds, launches


@contextlib.contextmanager
def draws_kept(record=None, replay=None, layout=None):
    """While open, every draw of the samplers is appended (on the CPU) to
    `record`, or replaced by the next of the `replay` draws (whole
    batches, cut to `layout`'s dp rows); the kernel still draws, so the
    launches and the generator's stream stay as they were (a spy on the
    name `engine.sample_from_logits`). The depth runs eagerly meanwhile
    (`tracing.recording()`: a graph's replay calls no spy)."""
    from hqtransformer_tpu_torch.sampling import engine
    from hqtransformer_tpu_torch.utils import tracing
    real = engine.sample_from_logits
    given = iter(replay or ())

    def spy(generator, logits, **kwargs):
        out = real(generator, logits, **kwargs)
        if replay is not None:
            whole = next(given)
            out = (whole if layout is None else layout.rows(whole)).to(
                out.device, out.dtype)
        if record is not None:
            record.append(out.cpu())
        return out
    engine.sample_from_logits = spy
    try:
        with tracing.recording():
            yield
    finally:
        engine.sample_from_logits = real


def tp_calibration(model, weights, labels, inputs, layout=None):
    """The int8 calibrations under `layout` (None: tp 1) on one batch:
    the KV scales of an N_TP_CALIB-position bf16 sampling run (seed 7)
    whose draws are tp 1's (`inputs['draws']`; at tp 1 they are recorded
    there), and the activation scales of the teacher-forced forward on
    `inputs`' B_TP_CALIB codes. Returns the scales on the CPU and the
    seconds."""
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    t0 = time.perf_counter()
    tp1 = layout is None
    if tp1:
        inputs['draws'] = []
    with draws_kept(inputs['draws'] if tp1 else None,
                    None if tp1 else inputs['draws'], layout):
        scales = model.calibrate_kv_scales(
            weights, torch.Generator(device='cuda').manual_seed(7), labels,
            SamplingParams(**SAMPLING_2048), max_seq_len=N_TP_CALIB)
    scales.update(model.calibrate_stage2_int8(
        weights, inputs['codes_t'], inputs['codes_b'],
        labels[:B_TP_CALIB]))
    torch.cuda.synchronize()
    return ({k: {n: t.cpu() for n, t in c.items()}
             for k, c in scales.items()}, time.perf_counter() - t0)


def scale_steps(got, want):
    """(scale values, the bit-equal ones, the largest |got - want| in bf16
    steps of want (2^-7 |want|)) of two calibrations, which must name the
    same scales of the same shapes."""
    n = same = 0
    worst = 0.0
    require(sorted(got) == sorted(want), f'collections {sorted(got)}')
    for key, coll in want.items():
        require(sorted(got[key]) == sorted(coll), f'{key} names differ')
        for name, w in coll.items():
            g = got[key][name]
            require(g.shape == w.shape, f'{name}: shape {tuple(g.shape)}')
            n += w.numel()
            same += int((g == w).sum())
            worst = max(worst, float(((g - w).abs() /
                                      (w.abs() * 2 ** -7)).max()))
    return n, same, worst


def tp_training(layout, vq, da, st):
    """The flagship's stage 2, f32, TP_TRAIN_STEPS steps under `layout`
    on this rank's rows of seeded global batches of B_TP_TRAIN: exactly
    2 K3 launches a step (stage 1 replicated on every tp rank), no K1 or
    K2; then the whole state saved at TP_DIR/ckpt (rank 0 writes).
    Returns (the dp-mean losses, seconds of the steps, of the save)."""
    from hqtransformer_tpu_torch.checkpoint import save_checkpoint
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.models.twostage import TwoStageModel
    from hqtransformer_tpu_torch.parallel.ddp import all_reduce_mean
    from hqtransformer_tpu_torch.train import stage2 as ts
    from hqtransformer_tpu_torch.train.scheduler import build_schedule

    cfg = build_twostage_config(str(FLAGSHIP))
    model = TwoStageModel(cfg, torch.float32, layout=layout)
    model.load_weights(model.init_weights(15))
    model.stage1.requires_grad_(False)
    step, state, _ = stage2_trainer(
        cfg, model, build_schedule(1e-3, 2, 10, warmup_epoch=1.0), layout)
    batches = train_batches(TP_TRAIN_STEPS, B_TP_TRAIN, 170)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts('k3.launches', 'k1.launches', 'k2.launches')
    losses, t0 = [], time.perf_counter()
    for x, y in batches:
        state, m = step(state, layout.rows(x), layout.rows(y))
        losses.append(float(all_reduce_mean(m['loss'], layout.dp_group)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts(vq, da, st)
    require(counts == (2 * TP_TRAIN_STEPS, 0, 0),
            f'tp training launches (K3, K1, K2) {counts}, not 2 K3 a step')
    require(all(math.isfinite(v) for v in losses), f'losses {losses}')
    t1 = time.perf_counter()
    save_checkpoint(str(TP_DIR / 'ckpt'), ts.train_state_dict(state, layout),
                    state.step, layout)
    saved = time.perf_counter() - t1
    print(f'rank {layout.rank}: tp 2 x dp 2 flagship f32 training (gloo on '
          f'one card): {TP_TRAIN_STEPS} steps in {seconds:.2f} s at global '
          f'batch {B_TP_TRAIN} ({B_TP_TRAIN // layout.dp} a dp rank), '
          f'{counts[0] // TP_TRAIN_STEPS} K3 launches a step, losses '
          f'{[round(v, 5) for v in losses]}; whole state saved in '
          f'{saved:.1f} s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f}'
          f' GiB allocated, {torch.cuda.max_memory_reserved() / 2**30:.2f} '
          f'reserved')
    return losses, seconds, saved


def run_tp_worker(rank: int, port: int) -> int:
    """One of TP_WORLD processes on cuda:0 (gloo): the collectives, the
    tp-4 (bf16 and int8max) and the tp-2 x dp-2 (bf16 and int8max, and
    f32 for the stage-2 loop, with a float and with an int8 KV cache)
    flagship sampler calls, the tp-2 x dp-2 calibration on tp 1's draws
    and codes, the training and its checkpoint; the int8 calls serve tp
    1's scales artifact (SCALES_PATH); what it found goes to
    TP_DIR/rank<r>.pt."""
    sys.path.insert(0, str(ROOT))
    from hqtransformer_tpu_torch.models.twostage import load_serving_scales
    from hqtransformer_tpu_torch.ops import decode_attention as da
    from hqtransformer_tpu_torch.ops import int8 as q8
    from hqtransformer_tpu_torch.ops import sample_topk as st
    from hqtransformer_tpu_torch.ops import vq_argmin as vq
    from hqtransformer_tpu_torch.parallel import ddp
    from hqtransformer_tpu_torch.parallel.tp import make_layout

    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # NCCL takes one rank a card: the ranks sharing cuda:0 join over gloo
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=TP_WORLD)
    layout = make_layout(2, 0)
    tp4 = make_layout(4, 0)
    gloo = '(gloo on one card)'
    scales = load_serving_scales(str(SCALES_PATH))
    try:
        check_collectives(layout)
        out = {'layout': (layout.dp_rank, layout.tp_rank)}
        out['tp4'] = tp_stage2_call(tp4, torch.bfloat16, N_TP4, da, st,
                                    f'rank {rank}: tp 4 stage-2 sampler, '
                                    f'bf16 {gloo}')
        out['tp4_int8'] = tp_stage2_call(
            tp4, torch.bfloat16, N_TP4, da, st, f'rank {rank}: tp 4 '
            f'stage-2 sampler, int8max {gloo}', q8.INT8MAX, scales)
        out['tp2'] = tp_sampler_call(
            layout, f'rank {rank}: tp 2 x dp 2 sampler {gloo}', da, st, q8)
        out['tp2_int8'] = tp_sampler_call(
            layout, f'rank {rank}: tp 2 x dp 2 int8max sampler {gloo}', da,
            st, q8, q8.INT8MAX, scales, tag='_int8')
        out['tp2_f32'] = tp_stage2_call(
            layout, torch.float32, T, da, st,
            f'rank {rank}: tp 2 x dp 2 stage-2 sampler, f32 {gloo}')
        out['tp2_f32_int8'] = tp_stage2_call(
            layout, torch.float32, N_TP_F32_INT8, da, st,
            f'rank {rank}: tp 2 x dp 2 stage-2 sampler, f32, int8 KV cache '
            f'{gloo}', q8.Int8Serving(kv_cache=True), scales)
        model, weights, labels = tp_flagship(layout)
        inputs = {k: v.cuda() if torch.is_tensor(v) else v for k, v in
                  torch.load(TP_DIR / 'calib_inputs.pt').items()}
        out['calib'] = tp_calibration(model, weights, labels, inputs, layout)
        print(f'rank {rank}: tp 2 x dp 2 calibration {gloo}: '
              f'{out["calib"][1]:.2f} s')
        del model, weights
        torch.cuda.empty_cache()
        out['train'] = tp_training(layout, vq, da, st)
        torch.save(out, TP_DIR / f'rank{rank}.pt')
    finally:
        ddp.cleanup()
    return 0


def spawn_tp_workers():
    """Run TP_WORLD `--tp-worker` processes of this script on cuda:0 and
    wait for them; rank 0's log is printed, and a failing rank's tail."""
    import socket

    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    logs = [open(TP_DIR / f'log{r}.txt', 'w') for r in range(TP_WORLD)]
    # four processes share the card: let each return what it frees
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF='expandable_segments:True')
    print(f'tp ranks start; this process holds '
          f'{torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card')
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               '--tp-worker', str(r), str(port)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              cwd=str(ROOT), env=env)
             for r in range(TP_WORLD)]
    t0 = time.perf_counter()
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    print((TP_DIR / 'log0.txt').read_text().rstrip())
    for r, rc in enumerate(rcs):
        if rc:
            print(f'--- tp rank {r} exited {rc}:\n' +
                  (TP_DIR / f'log{r}.txt').read_text()[-4000:])
    require(rcs == [0] * TP_WORLD, f'tp ranks exited {rcs}')
    print(f'{TP_WORLD} tp processes (gloo on one card): '
          f'{time.perf_counter() - t0:.1f} s of wall time')
    return [torch.load(TP_DIR / f'rank{r}.pt', weights_only=False)
            for r in range(TP_WORLD)]


def tp_codes(ranks, key, dp, tp):
    """The whole batch's codes of a tp sampler call (ranks[r][key] =
    (codes, seconds, launches)): the tp ranks of each dp group hold the
    same codes (checked), the dp groups' rows in order."""
    groups = [ranks[d * tp:(d + 1) * tp] for d in range(dp)]
    for g in groups:
        for r in g[1:]:
            require(all(torch.equal(a, b) for a, b in zip(g[0][key][0],
                                                          r[key][0])),
                    f'{key}: the tp ranks of a dp group drew differently')
    return [torch.cat(parts) for parts in zip(*(g[0][key][0]
                                                for g in groups))]


def one_step_off(x, g):
    """bf16 x with each value moved one bf16 step up or down in magnitude,
    at random (generator g; zeros stay)."""
    require(x.dtype == torch.bfloat16, 'the witness moves bf16')
    bits = x.contiguous().view(torch.int16)
    step = torch.randint(0, 2, bits.shape, generator=g, device=bits.device,
                         dtype=torch.int16) * 2 - 1
    step = torch.where((bits & 0x7fff) == 0, torch.zeros_like(step), step)
    return (bits + step).view(torch.bfloat16)


@contextlib.contextmanager
def logits_one_step_off(seed):
    """While open, every draw of the samplers takes its bf16 logits each
    moved one bf16 step up or down in magnitude, at random (seeded; zeros
    stay): the witness of how far a rounding of the logits moves the draws
    (a spy on the name `engine.sample_from_logits`). The depth runs
    eagerly meanwhile (`tracing.recording()`): a graph can neither call
    the spy nor draw from its generator."""
    from hqtransformer_tpu_torch.sampling import engine
    from hqtransformer_tpu_torch.utils import tracing
    real = engine.sample_from_logits
    g = torch.Generator(device='cuda').manual_seed(seed)

    def moved(generator, logits, **kwargs):
        return real(generator, one_step_off(logits, g), **kwargs)
    engine.sample_from_logits = moved
    try:
        with tracing.recording():
            yield
    finally:
        engine.sample_from_logits = real


@contextlib.contextmanager
def float_row_outputs_one_step_off(stage2, seed):
    """While open, the bf16 output of every float call of a row-parallel
    layer of `stage2` (`attn.proj`, `mlp.2`) moves one bf16 step up or
    down in magnitude at random (seeded; zeros stay); its A8W8 calls stay
    as they are. The witness of what tp changes under int8max: there tp
    leaves the A8W8 products bit-equal, and the only roundings it adds
    are those of the float row-parallel layers' partial sums (the
    depth-first step's, the cell embedding's), at most about a step each,
    which the int8 quantizers after them carry further than a logit's
    rounding (forward hooks; the depth eager, as under
    `logits_one_step_off`)."""
    from hqtransformer_tpu_torch.utils import tracing
    g = torch.Generator(device='cuda').manual_seed(seed)

    def moved(module, args, kwargs, out):
        int8 = kwargs.get('int8', args[1] if len(args) > 1 else False)
        return out if int8 else one_step_off(out, g)
    handles = [m.register_forward_hook(moved, with_kwargs=True)
               for name, m in stage2.named_modules()
               if name.endswith(('attn.proj', 'mlp.2'))]
    try:
        with tracing.recording():
            yield
    finally:
        for h in handles:
            h.remove()


def first_agreement(codes, ref):
    """The share of equal codes at the first position, a level each (top
    [n], bottoms [n, 4])."""
    return [float((a[:, 0].cpu() == b[:, 0].cpu()).float().mean())
            for a, b in zip(codes, ref)]


def witness_bound(p):
    """The least first-position agreement that a sampler whose logits move
    as much as the witness's would show: the witness's `p` less three
    standard deviations of the difference of two shares of B rows."""
    return p - 3 * math.sqrt(2 * p * (1 - p) / B)


def tp1_references(model, weights, labels, name, da, st, q8, int8=None,
                   scales=None, tag=''):
    """tp 1's flagship pixel sampler call (seed TP_SAMPLER_SEED; int8
    serving by `int8` and `scales`) in this process, its scorer's logits
    on its codes in the same mode, and the witness: the same call with
    every draw's bf16 logits one step off. The codes go to
    TP_DIR/ref_codes<tag>.pt for the ranks' scorers. Returns (codes on the
    CPU, the scorer's logits, the first-position agreement a level of the
    witness its codes are held to: the logits' in bf16, the float
    row-parallel outputs' under int8 gemms)."""
    from hqtransformer_tpu_torch.sampling.engine import (
        SamplingParams, make_hierarchical_scorer)

    int8 = int8 or q8.Int8Serving()
    sampler = model.make_pixel_sampler(params=SamplingParams(**SAMPLING_2048),
                                       int8=int8, scales=scales)
    gen = torch.Generator(device='cuda').manual_seed(TP_SAMPLER_SEED)
    ref, _ = sampler_call(model, weights, sampler, gen, labels,
                          f'tp 1 {name} reference sampler', da, st, q8,
                          int8=int8.kv_cache)
    ref_scores = make_hierarchical_scorer(model.stage2, T, int8, scales)(
        labels, *ref)
    ref = [c.cpu() for c in ref]
    # the witnesses: the same call with every draw's logits one step off;
    # under int8 serving also with the float row-parallel layers' outputs
    # one step off, the witness its codes are held to
    witnesses = [('every bf16 logit', logits_one_step_off(
        TP_SAMPLER_SEED + 1))]
    if int8.depth_gemms:
        witnesses.append(('every float row-parallel output',
                          float_row_outputs_one_step_off(
                              model.stage2, TP_SAMPLER_SEED + 2)))
    for what, witness in witnesses:
        with witness:
            gen = torch.Generator(device='cuda').manual_seed(TP_SAMPLER_SEED)
            _, moved = sampler(weights, gen, labels)
        moved_first = first_agreement(moved, ref)
        moved_all = [float((a.cpu() == b).float().mean())
                     for a, b in zip(moved, ref)]
        print(f'witness ({name}): tp 1 with {what} moved one bf16 step at '
              f'random against tp 1 (same weights, seed): codes equal at '
              f'the first position top {moved_first[0]:.4f}, bottom '
              f'{moved_first[1]:.4f}, over the {T} positions top '
              f'{moved_all[0]:.4f}, bottom {moved_all[1]:.4f}')
    torch.save(ref, TP_DIR / f'ref_codes{tag}.pt')
    del sampler, moved
    torch.cuda.empty_cache()
    return ref, ref_scores, moved_first


def check_tp_scores(ref_scores, tag, name):
    """The tp-2 x dp-2 scorer's logits (TP_DIR/scores<tag><dp>.pt)
    against tp 1's on tp 1's codes: within TP_LOGIT_STEPS bf16 steps of
    the largest logit, argmax equal in TP_ARGMAX_AGREEMENT of rows."""
    got = [torch.cat(parts) for parts in zip(*(
        torch.load(TP_DIR / f'scores{tag}{d}.pt')
        for d in range(TP_WORLD // 2)))]
    for level, g, w in zip(('top', 'bottom'), got, ref_scores):
        w = w.float().cpu()
        g = g.float()
        steps = float((g - w).abs().max()) / (float(w.abs().max()) * 2 ** -7)
        agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
        print(f'tp 2 x dp 2 scorer against tp 1 on tp 1\'s codes, {level} '
              f'logits ({name}): max |d| {steps:.2f} bf16 steps of the '
              f'largest logit (bound {TP_LOGIT_STEPS}), argmax equal in '
              f'{agree:.4f} of rows (bound {TP_ARGMAX_AGREEMENT})')
        require(steps <= TP_LOGIT_STEPS and agree >= TP_ARGMAX_AGREEMENT,
                f'tp scorer {name} {level}: {steps} steps, agreement '
                f'{agree}')


def run_tensor_parallel(da, st, vq):
    """Phase 17. Returns {name: (launches a rank, K1 max err, K1 times)}
    for the JSON line's decode_attention_tp2, _tp4, decode_attention_int8
    _tp2 and _int8_tp4."""
    from hqtransformer_tpu_torch.checkpoint import restore_checkpoint
    from hqtransformer_tpu_torch.models.stage2.hierarchical import \
        cells_to_raster
    from hqtransformer_tpu_torch.ops import int8 as q8
    from hqtransformer_tpu_torch.parallel.tp import ParallelLayout
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams
    from hqtransformer_tpu_torch.train import stage2 as ts
    from hqtransformer_tpu_torch.train.scheduler import build_schedule

    t0 = time.perf_counter()
    errs = check_k1_tp(da)
    times = {tp: time_k1_shape(da, T, d, n_heads, TIMED_POS, f'tp {tp} '
                               f'width')
             for tp, d, n_heads in TP_WIDTHS}
    errs8 = check_k1_int8_tp(da)
    times8 = {tp: time_k1_int8_shape(da, d, n_heads, f'tp {tp} width')
              for tp, d, n_heads in TP_WIDTHS}
    # tp 1 references in this process, before the ranks start: bf16, then
    # int8max with freshly calibrated scales (the artifact the ranks serve)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    model, weights, labels = bf16_model(
        FLAGSHIP, lambda cfg: torch.arange(B) % cfg.stage2.hparams.n_classes)
    ref, ref_scores, moved_first = tp1_references(model, weights, labels,
                                                  'bf16', da, st, q8)
    scales = calibrate_int8max(model, weights,
                               SamplingParams(**SAMPLING_2048), labels)
    ref8, ref8_scores, moved8_first = tp1_references(
        model, weights, labels, 'int8max', da, st, q8, q8.INT8MAX, scales,
        tag='_int8')
    # the calibration at tp 1 on one batch: its draws and codes go to the
    # ranks, which calibrate on the same
    codes_t = ref[0][:B_TP_CALIB].cuda()
    codes_b = cells_to_raster(ref[1][:B_TP_CALIB].cuda(), model.top_res,
                              model.cell_win).reshape(B_TP_CALIB, -1)
    calib_inputs = {'codes_t': codes_t, 'codes_b': codes_b}
    calib_ref, calib_s = tp_calibration(model, weights, labels, calib_inputs)
    torch.save({k: v.cpu() if torch.is_tensor(v) else v
                for k, v in calib_inputs.items()}, TP_DIR / 'calib_inputs.pt')
    print(f'tp 1 calibration on {B_TP_CALIB} samples\' codes and a '
          f'{N_TP_CALIB}-position sampling run: {calib_s:.2f} s '
          f'({len(calib_inputs["draws"])} draws recorded)')
    del model, weights
    torch.cuda.empty_cache()
    ref_f32 = tp_stage2_call(ParallelLayout(), torch.float32, T, da, st,
                             'tp 1 stage-2 sampler, f32')[0]
    ref_f32_int8 = tp_stage2_call(
        ParallelLayout(), torch.float32, N_TP_F32_INT8, da, st,
        'tp 1 stage-2 sampler, f32, int8 KV cache',
        q8.Int8Serving(kv_cache=True), scales)[0]
    ranks = spawn_tp_workers()
    require([r['layout'] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)],
            f'layouts {[r["layout"] for r in ranks]}')
    launches = {}
    bounds = {'bf16': [witness_bound(p) for p in moved_first],
              'int8max': [witness_bound(p) for p in moved8_first]}
    for tp, key, n, want, kind in (
            (2, 'tp2', T, ref, 'bf16'), (4, 'tp4', N_TP4, ref, 'bf16'),
            (2, 'tp2_f32', T, ref_f32, 'f32'),
            (2, 'tp2_int8', T, ref8, 'int8max'),
            (4, 'tp4_int8', N_TP4, ref8, 'int8max'),
            (2, 'tp2_f32_int8', N_TP_F32_INT8, ref_f32_int8, 'f32')):
        per_rank = {r[key][2] for r in ranks}
        require(per_rank == {(L * (n - 1), 2 * n)},
                f'{key}: K1, K2 launches a rank {per_rank}')
        launches.setdefault((tp, kind == 'int8max'), L * (n - 1))
        codes = tp_codes(ranks, key, TP_WORLD // tp, tp)
        agree = [float((a == b[:, :n]).float().mean())
                 for a, b in zip(codes, want)]
        first = first_agreement(codes, want)
        wall = max(r[key][1] for r in ranks)
        if kind == 'f32':
            least, why = [TP_F32_FIRST] * 2, 'f32'
        else:
            least, why = bounds[kind], f'{kind}; bound: its witness less 3 sd'
        cache = 'int8' if key.endswith('int8') else 'float'
        print(f'tp {tp} sampler against tp 1 (same weights, seed, batch '
              f'{B}; {why}; {cache} KV cache): codes equal at the first '
              f'position top {first[0]:.4f} (bound {least[0]:.4f}), bottom '
              f'{first[1]:.4f} (bound {least[1]:.4f}), over its {n} '
              f'positions top {agree[0]:.4f}, bottom {agree[1]:.4f} (a '
              f'moved draw changes every later step of its row); '
              f'{L * (n - 1)} K1 (d {D // tp}, {NH // tp} heads) and '
              f'{2 * n} K2 launches a rank; {wall:.2f} s a call (gloo on '
              f'one card, first call)')
        require(all(f >= b for f, b in zip(first, least)),
                f'{key}: first-position agreement {first}, bounds {least}')
    # the scorers' logits at tp 2 x dp 2 against tp 1's, on tp 1's codes
    check_tp_scores(ref_scores, '', 'bf16')
    check_tp_scores(ref8_scores, '_int8', 'int8max')
    del ref_scores, ref8_scores
    # the calibration at tp 2 x dp 2 against tp 1's, on the same batch
    first_calib = ranks[0]['calib'][0]
    for r in ranks[1:]:
        require(scale_steps(r['calib'][0], first_calib)[2] == 0.0,
                'the ranks calibrated different scales')
    n_scales, same, worst = scale_steps(first_calib, calib_ref)
    print(f'tp 2 x dp 2 calibration against tp 1 (the same {N_TP_CALIB}-'
          f'position draws, the same {B_TP_CALIB} samples\' codes; bf16): '
          f'{n_scales} scale values, every rank\'s the same, {same} '
          f'bit-equal to tp 1\'s, all within {worst:.2f} bf16 steps (bound '
          f'{TP_SCALE_STEPS}); {max(r["calib"][1] for r in ranks):.2f} s '
          f'(gloo on one card)')
    require(worst <= TP_SCALE_STEPS, f'tp calibration {worst} bf16 steps '
            f'off tp 1\'s')
    # tp 1 training on the whole batches, against the tp-2 x dp-2 state
    cfg, model = training_model(FLAGSHIP, torch.float32, 15)
    step, state, opt = stage2_trainer(
        cfg, model, build_schedule(1e-3, 2, 10, warmup_epoch=1.0))
    losses = []
    for x, y in train_batches(TP_TRAIN_STEPS, B_TP_TRAIN, 170):
        state, m = step(state, x, y)
        losses.append(float(m['loss']))
    tp_losses = ranks[0]['train'][0]
    tree = restore_checkpoint(str(TP_DIR / 'ckpt'), TP_TRAIN_STEPS)
    d = param_diffs(tree['params'], state.params)
    median, p99 = (float(torch.kthvalue(d, max(1, int(q * d.numel())))[0])
                   for q in (0.5, 0.99))
    # no bound on the largest difference: two Adam runs move a parameter
    # whose gradient is zero but for rounding by up to +-lr a step, so it
    # could not exceed the sum of the learning rates anyway
    print(f'tp 2 x dp 2 against tp 1, flagship f32, {TP_TRAIN_STEPS} steps '
          f'at batch {B_TP_TRAIN} (lr 5e-4, 1e-3, 9.6e-4): losses '
          f'{[round(v, 5) for v in tp_losses]} against '
          f'{[round(v, 5) for v in losses]} (rtol 1e-4); parameters differ '
          f'by median {median:.2e} (bound 1e-6), 99% within {p99:.2e} '
          f'(bound 1e-5), at most {float(d.max()):.2e}')
    require(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(tp_losses,
                                                              losses)),
            f'tp losses {tp_losses}, tp 1 {losses}')
    require(bool(torch.isfinite(d).all()) and median <= 1e-6 and
            p99 <= 1e-5, 'tp 2 parameters against tp 1')
    # the tp-2 checkpoint restored at tp 1, and one more step from it
    state = ts.load_train_state(state, tree)
    require(all(torch.equal(p.detach().cpu(), tree['params'][k])
                for k, p in state.params.items()),
            'restored parameters differ from the checkpoint')
    require(state.step == TP_TRAIN_STEPS and
            state.opt_state.count == TP_TRAIN_STEPS, 'restored counts')
    x, y = train_batches(1, B_TP_TRAIN, 171)[0]
    state, m = step(state, x, y)
    require(math.isfinite(float(m['loss'])), 'step after the restore')
    print(f'tp-2 checkpoint restored at tp 1: parameters equal the saved '
          f'ones, step {state.step} loss {float(m["loss"]):.4f}; save '
          f'{ranks[0]["train"][2]:.1f} s, tp-2 steps '
          f'{ranks[0]["train"][1]:.2f} s (gloo on one card)')
    del model, state, step, opt, tree, d
    torch.cuda.empty_cache()
    shutil.rmtree(TP_DIR / 'ckpt', ignore_errors=True)
    print(f'phase 17 (tensor parallelism): {time.perf_counter() - t0:.1f} s')
    out = {f'decode_attention_tp{tp}': (launches[tp, False], errs[tp],
                                        times[tp]) for tp in (2, 4)}
    out.update({f'decode_attention_int8_tp{tp}': (
        launches[tp, True], errs8[tp], times8[tp]) for tp in (2, 4)})
    return out

# ------------------------------------------- phase 18: GroupNorm-swish kernel

GN_SEEDS = {'decode': 181, 'encode': 183}
# |kernel - plain| allowed. The kernel sums the statistics in another order,
# which moves the f32 value y = a x + b by about 1e-6 of the map's scale
# (maps here are of unit scale; `gn_accuracy` holds the statistics to
# float64). In bf16 that moves y across a rounding boundary now and then:
# the rounded y of the two differ by at most a step, 2^-7 |y|. Swish
# carries that through its slope (at most 1.1) and adds a step of the
# rounded sigmoid times |y| (2^-7 |out|) and one of the rounded product
# (2^-7 |out|): |diff| <= 2^-7 (1.1 |y| + 2 |out|) + GN_ABS, GN_ABS for
# values near 0, whose steps are finer than the statistics' own error; at
# most GN_SHARE of the elements may differ at all. In f32 nothing rounds to
# a coarser type: GN_ABS of max(1, |value|).
GN_STEP = 2.0 ** -7
GN_ABS = 1e-5
GN_SHARE = 0.01


def gn_generator(cfg, dtype, serving):
    """A stage-1 generator of `cfg` on the card, computing in `dtype`, with
    seeded random weights: bf16 serving weights (1-D ones, GroupNorm's
    among them, stay f32) or the f32 weights training holds."""
    from hqtransformer_tpu_torch.evaluation.stage1 import init_stage1_weights
    from hqtransformer_tpu_torch.models.stage1.generator import \
        build_generator
    from hqtransformer_tpu_torch.models.twostage import serving_bf16_params

    with torch.device('meta'):
        gen = build_generator(cfg, dtype)
    weights = init_stage1_weights(cfg, seed=180, device='cuda')
    if serving:
        weights = serving_bf16_params(weights)
    gen.load_state_dict(weights, strict=True, assign=True)
    return gen.eval().requires_grad_(False)


def gn_sites(name, gen, run, launches):
    """Run `run()` once with a hook on every GroupNorm: require `launches`
    kernel pairs, no layout copy, every input and output channels-last;
    return {(B, C, H, W, dtype, weight dtype, swish): sites}."""
    from hqtransformer_tpu_torch.models.stage1.layers import GroupNorm
    from hqtransformer_tpu_torch.ops import group_norm as gn

    sites, layouts = {}, []

    def pre(m, args, kwargs):
        x = args[0]
        key = (*x.shape, x.dtype, m.weight.dtype, kwargs.get('swish', False))
        sites[key] = sites.get(key, 0) + 1
        layouts.append(gn.is_channels_last(x))

    def post(m, args, kwargs, out):
        layouts.append(gn.is_channels_last(out))

    hooks = [h for m in gen.modules() if isinstance(m, GroupNorm)
             for h in (m.register_forward_pre_hook(pre, with_kwargs=True),
                       m.register_forward_hook(post, with_kwargs=True))]
    reset_counts('gn.launches', 'gn.layout_copies')
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    got = (since_reset('gn.launches'), since_reset('gn.layout_copies'))
    require(got == (launches, 0), f'{name}: gn.launches, gn.layout_copies '
            f'{got}, expected ({launches}, 0)')
    require(all(layouts), f'{name}: a GroupNorm input or output is not '
            f'channels-last')
    require(out.dim() != 4 or out.is_contiguous(), f'{name}: pixels not '
            f'NHWC-contiguous')
    print(f'{name}: gn.launches {got[0]}, gn.layout_copies {got[1]}, every '
          f'GroupNorm input and output channels-last; output '
          f'{tuple(out.shape)}')
    return sites


def gn_main_paths():
    """The flagship decode chunk (bf16 serving weights, batch 128), the
    3-level decode chunk (batch 128) and stage-2 training's frozen encode
    (bf16 on f32 weights, batch 64), each run once on the card with its
    counts checked. Returns their sites and the flagship decode chunk."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.train import stage2 as tr2

    g = torch.Generator(device='cuda').manual_seed(GN_SEEDS['decode'])

    def codes(*sides):
        return [torch.randint(0, N_CODES, (B, s, s), generator=g,
                              device='cuda') for s in sides]

    flagship = build_twostage_config(str(FLAGSHIP)).stage1
    gen = gn_generator(flagship, torch.bfloat16, serving=True)
    ct, cb = codes(8, 16)

    @torch.inference_mode()
    def decode():
        return gen.decode_code(ct, cb)

    sites = {'flagship decode chunk': gn_sites(
        'flagship decode chunk (batch 128)', gen, decode, 33)}
    level3 = build_twostage_config(str(LEVEL3_S2)).stage1
    gen3 = gn_generator(level3, torch.bfloat16, serving=True)
    maps = codes(8, 16, 32)
    sites['3-level decode chunk'] = gn_sites(
        '3-level decode chunk (batch 128)', gen3,
        torch.inference_mode()(lambda: gen3.decode_code(maps)), 27)
    del gen3, maps
    train = gn_generator(flagship, torch.bfloat16, serving=False)
    images = seeded_images(B_TRAIN2, flagship.hparams.resolution,
                           seed=GN_SEEDS['encode'])
    sites['training encode'] = gn_sites(
        'stage-2 training encode (batch 64)', train,
        lambda: torch.stack([c.float().mean() for c in tr2.stage1_codes(
            train, images)[0]]), 22)
    del train, images
    return sites, decode


def gn_case(b, c, h, w, dtype, w_dtype, seed, offset=0.0):
    """A channels-last [b, c, h, w] map whose channels have means in
    offset + [-3, 3] and spreads in [0.5, 2], and a weight and bias of c."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    mean = torch.rand(c, generator=g, device='cuda') * 6 - 3 + offset
    std = torch.rand(c, generator=g, device='cuda') * 1.5 + 0.5
    x = torch.randn((b, h, w, c), generator=g, device='cuda')
    x = (x.mul_(std).add_(mean)).to(dtype).permute(0, 3, 1, 2)
    weight = (torch.rand(c, generator=g, device='cuda') + 0.5).to(w_dtype)
    bias = (torch.randn(c, generator=g, device='cuda') * 0.5).to(w_dtype)
    return x, weight, bias


def gn_compare(gn, x, weight, bias, with_swish, label):
    """The kernel against the plain version on one map: require the bounds
    above; returns (max |diff|, share of elements that differ)."""
    got = gn.group_norm_swish(x, weight, bias, 1e-6, with_swish)
    torch.cuda.synchronize()
    want = gn.group_norm_swish_plain(x, weight, bias, 1e-6, with_swish)
    require(got.dtype == x.dtype and gn.is_channels_last(got),
            f'{label}: output {got.dtype}, not channels-last')
    diff = (got.float() - want.float()).abs()
    out = torch.maximum(got.float().abs(), want.float().abs())
    if x.dtype == torch.bfloat16:
        y = (gn.group_norm_swish_plain(x, weight, bias, 1e-6).float().abs()
             if with_swish else out)
        allowed = GN_STEP * (1.1 * y + 2 * out) + GN_ABS
    else:
        allowed = GN_ABS * out.clamp(min=1.0)
    share = float((diff > 0).float().mean())
    err = float(diff.max())
    use = float((diff / allowed).max())
    print(f'  group_norm {label}: max |diff| {err:.3e}, largest share of the '
          f'bound used {use:.3f}, elements differing {share:.2e}')
    if use > 1:
        i = int((diff / allowed).flatten().argmax())
        print(f'    worst: kernel {float(got.flatten()[i])}, plain '
              f'{float(want.flatten()[i])}, allowed '
              f'{float(allowed.flatten()[i])}')
    require(use <= 1 and bool(torch.isfinite(got).all()),
            f'group_norm {label}: beyond the bound')
    if x.dtype == torch.bfloat16:
        require(share <= GN_SHARE, f'group_norm {label}: {share:.2e} of the '
                f'elements differ')
    return err, share


def gn_accuracy(gn, b, c, h, w, seed, offset=0.0):
    """The statistics against float64: the kernel (at the served batch,
    so at the served tiles) and F.group_norm on the same f32 map, weight 1,
    bias 0, no swish; each one's largest |error| of the normalised value
    over the first 16 samples. Requires the kernel's to be within twice
    F.group_norm's plus 1e-6: its sums are as sound as PyTorch's Welford."""
    x, _, _ = gn_case(b, c, h, w, torch.float32, torch.float32, seed,
                      offset=offset)
    one = torch.ones(c, device='cuda')
    zero = torch.zeros(c, device='cuda')
    k = gn.group_norm_swish(x, one, zero, 1e-6)[:16]
    p = torch.nn.functional.group_norm(x, 32, one, zero, 1e-6)[:16]
    n = min(b, 16)
    g = x[:n].double().permute(0, 2, 3, 1).reshape(n, h * w, 32, c // 32)
    var, mean = torch.var_mean(g, dim=(1, 3), correction=0, keepdim=True)
    ref = ((g - mean) * (var + 1e-6).rsqrt()).reshape(n, h, w, c).permute(
        0, 3, 1, 2)
    ek = float((k.double() - ref).abs().max())
    ep = float((p.double() - ref).abs().max())
    print(f'  group_norm statistics [{b}, {c}, {h}, {w}] f32, offset '
          f'{offset}: |normalised - float64| kernel {ek:.3e}, F.group_norm '
          f'{ep:.3e}')
    require(ek <= 2 * ep + 1e-6, f'group_norm statistics [{b}, {c}, {h}, '
            f'{w}]: kernel {ek:.3e} against F.group_norm {ep:.3e}')
    return ek


def gn_bytes(b, c, h, w, dtype):
    """Bytes the function must move: the map read once and written once."""
    return 2 * b * c * h * w * dtype.itemsize


def time_group_norm(gn, shapes):
    """Kernel, plain version and F.silu(F.group_norm) on each served shape
    (channels-last bf16, f32 weights, with swish as the resblocks run it),
    each beside the bytes bound and the design's floor (the map read
    twice, written once). Returns {shape: (ms, plain, library, bound)}."""
    fn = torch.nn.functional
    out = {}
    print('group_norm times (ms a call; bound: the map read once and written '
          'once at 3.35 TB/s; floor: read twice, written once):')
    for b, c, h, w in shapes:
        x, weight, bias = gn_case(b, c, h, w, torch.bfloat16, torch.float32,
                                  seed=190)
        wl, bl = weight.to(x.dtype), bias.to(x.dtype)
        ms = time_ms(lambda i: gn.group_norm_swish(x, weight, bias, 1e-6,
                                                   True), 20)
        plain = time_ms(lambda i: gn.group_norm_swish_plain(
            x, weight, bias, 1e-6, True), 5)
        lib = time_ms(lambda i: fn.silu(fn.group_norm(x, 32, wl, bl, 1e-6)),
                      10)
        bnd = gn_bytes(b, c, h, w, x.dtype) / HBM_BYTES_PER_S * 1e3
        floor = 1.5 * bnd
        print(f'  [{b}, {c}, {h}, {w}] bf16: kernel {ms:.4f} '
              f'({bnd / ms:.1%} of the bound, {floor / ms:.1%} of the floor, '
              f'{1.5 * gn_bytes(b, c, h, w, x.dtype) / ms / 1e6:.0f} GB/s '
              f'moved), plain {plain:.4f}, F.group_norm + F.silu {lib:.4f}, '
              f'bound {bnd:.4f}')
        out[b, c, h, w] = (ms, plain, lib, bnd)
        del x
    return out


def run_group_norm():
    """Phase 18: the GroupNorm-swish kernel on every shape the main paths
    run it at, its counts there, and its times. Returns the result line's
    entry."""
    from hqtransformer_tpu_torch.ops import group_norm as gn

    t0 = time.perf_counter()
    sites, decode = gn_main_paths()
    served = sorted({k[:4] for k in sites['flagship decode chunk']} |
                    {k[:4] for k in sites['3-level decode chunk']} |
                    {k[:4] for k in sites['training encode']})
    for i, shape in enumerate(served):
        gn_accuracy(gn, *shape, seed=500 + i)
    gn_accuracy(gn, 32, 128, 128, 128, seed=520, offset=40.0)
    keys = sorted({k for s in sites.values() for k in s},
                  key=lambda k: (k[0], k[1], k[2], str(k[4]), k[6]))
    err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for i, (b, c, h, w, dtype, w_dtype, with_swish) in enumerate(keys):
        label = (f'[{b}, {c}, {h}, {w}] {str(dtype)[6:]}, weight '
                 f'{str(w_dtype)[6:]}, swish {with_swish}')
        x, weight, bias = gn_case(b, c, h, w, dtype, w_dtype, seed=200 + i)
        err[dtype] = max(err[dtype], gn_compare(gn, x, weight, bias,
                                                with_swish, label)[0])
        del x
    # beyond the served ones: f32 maps, bf16 weights, maps far off 0 (the
    # shift), NCHW input (one layout copy), a C of 2 channels a group, and
    # a map whose last tile is short
    extra = ((64, 128, 64, 64, torch.float32, torch.float32, True, 0.0),
             (64, 512, 16, 16, torch.float32, torch.float32, False, 0.0),
             (128, 256, 32, 32, torch.bfloat16, torch.bfloat16, True, 0.0),
             (32, 128, 128, 128, torch.float32, torch.float32, True, 40.0),
             (32, 128, 64, 64, torch.bfloat16, torch.float32, False, 8.0),
             (16, 64, 24, 40, torch.bfloat16, torch.float32, True, 0.0),
             (8, 32, 13, 11, torch.float32, torch.float32, True, 0.0))
    for i, (b, c, h, w, dtype, w_dtype, with_swish, offset) in enumerate(
            extra):
        x, weight, bias = gn_case(b, c, h, w, dtype, w_dtype, seed=300 + i,
                                  offset=offset)
        gn_compare(gn, x, weight, bias, with_swish,
                   f'[{b}, {c}, {h}, {w}] {str(dtype)[6:]}, weight '
                   f'{str(w_dtype)[6:]}, swish {with_swish}, offset {offset}')
    x, weight, bias = gn_case(4, 256, 16, 16, torch.bfloat16, torch.float32,
                              seed=400)
    reset_counts('gn.layout_copies')
    gn_compare(gn, x.contiguous(), weight, bias, True, 'NCHW input')
    require(since_reset('gn.layout_copies') == 1, 'an NCHW input was not '
            'counted as one layout copy')
    first = gn.group_norm_swish(x, weight, bias, 1e-6, True)
    require(all(torch.equal(first, gn.group_norm_swish(
        x, weight, bias, 1e-6, True)) for _ in range(3)),
        'the kernel does not repeat itself')
    del x, first
    times = time_group_norm(gn, served)
    for path, s in sites.items():
        sums = [sum(n * times[k[:4]][j] for k, n in s.items())
                for j in range(4)]
        per = B if 'decode' in path else B_TRAIN2
        print(f'group_norm over a {path} ({sum(s.values())} sites): kernel '
              f'{sums[0]:.3f} ms, plain {sums[1]:.3f}, F.group_norm + '
              f'F.silu {sums[2]:.3f}, bound {sums[3]:.3f} '
              f'({sums[0] / per:.5f} ms a sample)')
    profile_phases((('flagship decode chunk (batch 128)', decode),))
    print(f'phase 18 (GroupNorm-swish): {time.perf_counter() - t0:.1f} s')
    ms, plain, lib, bnd = times[B, 128, 256, 256]
    return {'name': 'group_norm', 'route': 'cuda',
            'source': 'hqtransformer_tpu_torch/csrc/group_norm.cu',
            'replaces': None, 'launches': sum(
                sites['flagship decode chunk'].values()),
            'max_abs_err': max(err.values()), 'ms': ms, 'kernel_ms': ms,
            'plain_ms': plain, 'bound_ms': bnd, 'bound_by': 'bytes',
            'library_ms': lib, 'shape': [B, 128, 256, 256]}



def graphs_case(model, weights_dicts, labels, params, name, calls=3):
    """Phase 19's check of one model: each call of `make_pixel_sampler`
    eagerly and from graphs, the generator seeded alike."""
    from hqtransformer_tpu_torch.utils import tracing

    sampler = model.make_pixel_sampler(params=params)
    gen = torch.Generator(device='cuda')
    for w, weights in enumerate(weights_dicts):
        for call in range(calls):
            gen.manual_seed(1000 * w + call)
            reset_counts('k2.launches')
            with tracing.recording():
                want_px, want = sampler(weights, gen, labels)
            want_k2 = since_reset('k2.launches')
            want_state = gen.get_state()
            gen.manual_seed(1000 * w + call)
            reset_counts('k2.launches')
            px, got = sampler(weights, gen, labels)
            torch.cuda.synchronize()
            what = f'{name}, weights {w}, call {call}'
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f'{what}: graphed codes differ from the eager ones')
            require(torch.equal(px, want_px),
                    f'{what}: graphed pixels differ from the eager ones')
            require(torch.equal(gen.get_state(), want_state),
                    f'{what}: the generator moved otherwise than eagerly')
            k2 = since_reset('k2.launches')
            require(k2 == want_k2,
                    f'{what}: K2 launches {k2}, eagerly {want_k2}')
    print(f'depth graphs {name}: {len(weights_dicts)} x {calls} calls equal '
          f'to the eager ones')


def run_depth_graphs():
    """Phase 19 (see the module docstring)."""
    from hqtransformer_tpu_torch.config import build_twostage_config
    from hqtransformer_tpu_torch.models.twostage import (TwoStageModel,
                                                         serving_bf16_params)
    from hqtransformer_tpu_torch.sampling.engine import SamplingParams

    def weights_dicts(model):
        return [{s: {k: v.cuda() for k, v in serving_bf16_params(w).items()}
                 for s, w in model.init_weights(seed=seed).items()}
                for seed in (0, 1)]

    t0 = time.perf_counter()
    tiny = SamplingParams(top_k_top=16, top_k_bot=16)
    cases = (('parallel', 'hq-transformer/parallel', tiny),
             ('parallel top-p', 'hq-transformer/parallel',
              SamplingParams(top_p_top=0.9, top_p_bot=0.9)),
             ('parallel bisect3', 'hq-transformer/parallel',
              SamplingParams(top_k_top=16, top_k_bot=16, bisect3=True)),
             ('bidirectional', 'hq-transformer/bidirectional4', tiny),
             ('top2bot', 'hq-transformer', tiny))
    for name, kind, params in cases:
        cfg = build_twostage_config(str(TINY))
        cfg.stage2.type = kind
        model = TwoStageModel(cfg, dtype=torch.bfloat16)
        labels = (torch.arange(8) % cfg.stage2.hparams.n_classes).cuda()
        graphs_case(model, weights_dicts(model), labels, params,
                    f'tiny {name}')
    flagship = dict(top_k_top=2048, top_k_bot=2048, temperature_top=0.95,
                    temperature_bot=0.95)
    for name, path, labels_of in (
            ('flagship', FLAGSHIP,
             lambda cfg: torch.arange(64) % cfg.stage2.hparams.n_classes),
            ('cc15m text', ROOT / 'configs/cc15m/stage2/'
             'hqtransformer-l12-cc15m.yaml',
             lambda cfg: caption_ids(cfg.stage2.hparams.ctx_len_txt)[:32])):
        cfg = build_twostage_config(str(path))
        model = TwoStageModel(cfg, dtype=torch.bfloat16)
        graphs_case(model, weights_dicts(model), labels_of(cfg).cuda(),
                    SamplingParams(**flagship), name)
        del model
        torch.cuda.empty_cache()
    print(f'phase 19 (depth graphs): {time.perf_counter() - t0:.1f} s')


def parse_args(argv):
    ap = argparse.ArgumentParser(
        description='Smoke test of the PyTorch/CUDA port on one GPU; with '
        'no arguments, every phase and the result line.')
    ap.add_argument('--k1-only', action='store_true',
                    help='build the kernels, run the K1 checks, timings and '
                    'sweep, and stop (no result line)')
    ap.add_argument('--gn-only', action='store_true',
                    help='build the kernels, run phase 18 (GroupNorm-swish) '
                    'and stop (its kernel entry is the result line)')
    ap.add_argument('--graphs-only', action='store_true',
                    help='build the kernels, run phase 19 (the depth '
                    'graphs) and stop (no result line)')
    ap.add_argument('--tp-worker', nargs=2, type=int, metavar=('RANK', 'PORT'),
                    help='run as one rank of phase 17 (started by the '
                    'script itself)')
    return ap.parse_args(argv)


def run_k1_only(da):
    """The K1 checks and timings of phases 2 and 7 and the sweep."""
    check_decode_attention(da)
    check_decode_attention_int8(da)
    time_decode_attention(da)
    time_decode_attention_int8(da)
    time_decode_attention_int8_large(da)
    sweep_decode_attention(da)
    print('chip_smoke --k1-only: every K1 check passed')
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    if args.tp_worker:
        return run_tp_worker(*args.tp_worker)
    sys.path.insert(0, str(ROOT))
    from hqtransformer_tpu_torch.ops import cuda_build
    from hqtransformer_tpu_torch.ops import decode_attention as da
    from hqtransformer_tpu_torch.ops import sample_topk as st
    from hqtransformer_tpu_torch.ops import vq_argmin as vq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f'device: {kind} (count {count}); nvidia-smi: {smi}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, python '
          f'{sys.version.split()[0]}; TF32 off for matmul and cuDNN')
    t0 = time.perf_counter()
    messages = cuda_build.build()
    print(f'kernels built in {time.perf_counter() - t0:.1f} s '
          f'({", ".join(cuda_build.KERNEL_SOURCES)})')
    for name, text in messages.items():
        print_ptxas_report(name, text)
    print_sass_conversions(cuda_build.library_path('decode_attention'),
                           'decode_attention')
    if args.k1_only:
        return run_k1_only(da)
    if args.gn_only:
        print(json.dumps({'kernels': [run_group_norm()]}))
        print('chip_smoke --gn-only: every GroupNorm check passed')
        return 0
    if args.graphs_only:
        run_depth_graphs()
        print('chip_smoke --graphs-only: every depth graph check passed')
        return 0

    k1_err = check_decode_attention(da)
    k2_err, k2_frac = check_sample_topk(st)
    k3_err = check_vq_argmin(vq)
    k1_times = time_decode_attention(da)
    sweep_decode_attention(da)
    k2_times = time_sample_topk(st)
    k2b_err = check_sample_topk_bisect3(st)
    k2b_times = time_sample_topk_level3(st)
    k3_shapes, k3_served_err = time_vq_argmin(vq, torch.bfloat16)
    k3f_shapes, k3f_served_err = time_vq_argmin(vq, torch.float32)
    launches, samples_per_s, model, weights = run_main_path(da, st)
    k1i_err, k1i_times, k1i_launches = run_int8max(da, st, model, weights)
    k3_launches, images_per_s = run_encode_slice(vq, da, st,
                                                 weights['stage1'])
    run_twostage_encode(vq, da, st, model, weights)
    del model, weights
    torch.cuda.empty_cache()
    from hqtransformer_tpu_torch.ops import int8 as q8
    (k2b_launches, level3_samples_per_s, model, weights,
     bf16_codes) = run_level3_sampling(da, st, q8)
    run_level3_int8max(da, st, q8, model, weights, bf16_codes)
    del model, weights, bf16_codes
    torch.cuda.empty_cache()
    run_top4x4(da, st, q8)
    torch.cuda.empty_cache()
    run_conditioned(da, st, q8)
    (k1f_launches, k1f_err, k1f_times), (k2j_launches, k2j_err,
                                         k2j_times) = run_other_samplers(
        da, st, q8)
    run_level3(vq, da, st)
    k3f_launches, f32_images_per_s = run_encode_f32(vq, da, st)
    stage1_rates, k3d_launches = run_stage1_rest(vq, da, st)
    k1ft_launches, k1ft_err, k1ft_times = run_serving_rest(da, st, q8)
    k3e_launches = run_eval_pipeline(vq, da, st)
    k3t2_launches, k3t2_err, k3t2_times = run_stage2_training(vq, da, st)
    k3t1_launches, k3t1_err, k3t1_times = run_stage1_training(vq, da, st)
    k1_tp = run_tensor_parallel(da, st, vq)
    gn_entry = run_group_norm()
    run_depth_graphs()
    require(k3_shapes[K3_D256][5] == 0 and k3f_shapes[K3_D256][5] == 0,
            'K3 at the avgpool / conv2 top differs from plain')
    check_small_reference(vq)
    check_level3_reference(st)
    check_top2mid2bot_reference()
    check_conditioned_reference()
    check_other_samplers_reference()
    check_stage1_variants_reference(vq)
    check_int8_references()

    kernels = []
    source = 'hqtransformer_tpu_torch/csrc/'
    for name, src, replaces, n, err, (ms, plain, lib, (bnd, by)) in (
            ('decode_attention', source + 'decode_attention.cu',
             'hqtransformer_tpu/ops/pallas_attention.py:200', launches[0],
             k1_err, k1_times),
            ('decode_attention_int8', source + 'decode_attention.cu',
             'hqtransformer_tpu/ops/pallas_attention.py:200', k1i_launches,
             k1i_err, k1i_times),
            ('decode_attention_t320', source + 'decode_attention.cu',
             'hqtransformer_tpu/ops/pallas_attention.py:200', k1f_launches,
             k1f_err, k1f_times),
            ('decode_attention_int8_t320', source + 'decode_attention.cu',
             'hqtransformer_tpu/ops/pallas_attention.py:200', k1ft_launches,
             k1ft_err, k1ft_times),
            *((name, source + 'decode_attention.cu',
               'hqtransformer_tpu/ops/pallas_attention.py:200', *entry)
              for name, entry in k1_tp.items()),
            ('sample_topk', source + 'sample_topk.cu',
             'hqtransformer_tpu/ops/pallas_sample.py:236', launches[1],
             k2_err, k2_times),
            ('sample_topk_640', source + 'sample_topk.cu',
             'hqtransformer_tpu/ops/pallas_sample.py:236', k2j_launches,
             k2j_err, k2j_times),
            ('sample_topk_bisect3', source + 'sample_topk.cu',
             'hqtransformer_tpu/ops/pallas_sample.py:236 (bisect3)',
             k2b_launches, k2b_err, k2b_times),
            ('vq_argmin', source + 'vq_argmin.cu',
             'hqtransformer_tpu/ops/pallas_vq.py:63', k3_launches,
             max(k3_err, k3_served_err), flagship_entry(k3_shapes)),
            ('vq_argmin_f32', source + 'vq_argmin.cu',
             'hqtransformer_tpu/ops/pallas_vq.py:63', k3f_launches,
             max(k3_err, k3f_served_err), flagship_entry(k3f_shapes)),
            ('vq_argmin_d256', source + 'vq_argmin.cu',
             'hqtransformer_tpu/ops/pallas_vq.py:63', k3d_launches,
             max(k3_err, k3_served_err), k3_shapes[K3_D256][:4]),
            ('vq_argmin_f32_eval', source + 'vq_argmin.cu',
             'hqtransformer_tpu/ops/pallas_vq.py:63', k3e_launches,
             max(k3_err, k3f_served_err), flagship_entry(k3f_shapes)),
            ('vq_argmin_stage2_train', source + 'vq_argmin.cu',
             'hqtransformer_tpu/ops/pallas_vq.py:63', k3t2_launches,
             k3t2_err, k3t2_times),
            ('vq_argmin_stage1_train', source + 'vq_argmin.cu',
             'hqtransformer_tpu/ops/pallas_vq.py:63', k3t1_launches,
             k3t1_err, k3t1_times)):
        kernels.append({'name': name, 'route': 'cuda', 'source': src,
                        'replaces': replaces, 'launches': n,
                        'max_abs_err': err, 'ms': ms, 'kernel_ms': ms,
                        'plain_ms': plain, 'bound_ms': bnd, 'bound_by': by,
                        'library_ms': lib})
    # the training paths' K3 entries: f32 z and codebook, launches a step
    for entry, per_step in zip(kernels[-2:], (2, 4)):
        entry.update(dtype='float32', launches_per_step=per_step)
    kernels.append(gn_entry)
    print(f'K2 rows differing from plain at most {k2_frac:.4f}; main path '
          f'{samples_per_s:.2f} samples/s at batch {B}; 3-level sampling '
          f'{level3_samples_per_s:.2f} samples/s at batch {B}; encode slice '
          f'{images_per_s:.2f} images/s at batch {B} in bf16, '
          f'{f32_images_per_s:.2f} in f32; ' + '; '.join(
              f'{stem} {r[torch.bfloat16]:.2f} in bf16, '
              f'{r[torch.float32]:.2f} in f32'
              for stem, r in stage1_rates.items()))
    print(json.dumps({'kernels': kernels}))
    print(f'nvidia-smi: {nvidia_smi()}')
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': count}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
