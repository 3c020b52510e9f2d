#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``lipreading_video_generation_tpu_torch``'s ported paths on random
weights made from a seed, and checks every hand-written kernel on them:

- the lipreader's serving path — mouth-ROI preprocessing, then the ViViT
  word-classifier forward — at the ``ViViTConfig`` defaults (12 layers,
  hidden 256, 8 heads, MLP 1024, bf16, 64 classes); its attention is the
  small-MHA kernel K2, in bf16 the tensor-core one
  (``csrc/small_mha_sm90.cu``);
- ViViT training through the port's command line (``cli.main(["train-vivit",
  ...])``: synthetic word clips, AdamW with the staircase schedule, an eval
  after each epoch, the best-accuracy params) at the same defaults with 8
  classes, batch 16: K2 forward in every training step and eval batch, its
  backward the einsum VJP under autograd;
- the lipreading chain end to end (``pipelines.lipreading_e2e.run``): LRS2-
  style records → S3FD face tracks (VGG16, batch 16, 160×160 frames) →
  mouth boxes → ROI (K1 once a clip, packed route) → word clips → ViViT
  training and prediction at the defaults (K2, bf16, tensor-core route) →
  sentence eval with the trained causal word LM at the ``NeuralScorer``
  defaults (K2, float32, causal, CUDA-core route); then a pass with a
  trained lip-landmark net;
- diffusion sampling — uint8 condition frame + raw audio → native audio
  encoder → conditioning map → DDIM / DPM++ denoise steps of the U-Net →
  uint8 frames — at the ``DiffusionConfig`` defaults (128×128, base 64,
  channel_mult (1,2,4), 2 res blocks, attention at ds 1/2/4, 1 head, bf16);
  its attention is the flash forward K3, in bf16 the tensor-core kernel
  (``csrc/flash_fwd_sm90.cu``);
- diffusion training — uint8 target/condition frames + raw audio →
  ``prepare_batch`` → q-sample → U-Net forward in train mode (dropout 0.1)
  → ε-MSE → backward through the flash backward kernels (in bf16 the
  tensor-core ones, ``csrc/flash_bwd_sm90.cu``) → Adam → EMA — at the same
  defaults, batch 8;
- the super-resolution stage (``SuperResConfig`` defaults: training, then
  the two-stage cascade) and classifier guidance (``ClassifierConfig``
  defaults: training, then a guided request), the other two users of the
  flash backward;
- lip-sync serving — host uint8 frames, face boxes and mel windows →
  ``pipelines.inference.generate_frames`` (crop, mask, the talking-face
  generator, paste back) → host uint8 frames — at the ``GanConfig`` /
  ``PreprocessConfig`` defaults (width 1.0, 96×96 faces, batches of 128), in
  float, dynamic int8 and static int8; in the int8 modes each of the
  generator's 51 convolutions is one launch of the int8 matmul kernel K6,
  by its tensor-core route (``csrc/int8_mm_sm90.cu``);
- the rest of the lip-sync GAN: one G+D step of ``pipelines.train_gan``
  (generator against the discriminator and the frozen SyncNet, two Adams)
  at the ``GanConfig`` defaults (width 1.0, 96×96 faces, T 5, batch 16,
  bf16), the expert chain through the command line (``train-syncnet`` →
  ``train-gan`` → ``eval-gan``), ``lipsync_video`` from a wav and frames in
  memory (S3FD face tracks, mel windows, ``generate_frames``; K6 in the int8
  modes) and ``ops/image.contrast_boost`` on whole frames (K1 by its tiled
  route); the GAN step itself runs no hand-written kernel (convolutions,
  GroupNorm, BCE and Adam are library and plain torch work, as in the JAX
  package, where XLA does it);
- the data feed: a frame index of in-memory videos, diffusion records
  packed from it, ``train-diffusion --records-root`` streaming them through
  the port's native prefetch loader (``csrc/prefetch_loader.cpp``, built
  with g++) four steps a dispatch at the ``DiffusionConfig`` defaults (K2-K5
  in every step), ``sample-diffusion`` on the checkpoint it wrote (K2, K3),
  and ``pack-gan-records`` → ``train-gan --records-root`` at the
  ``GanConfig`` defaults;
- the pretrained encoders: wav2vec2 base (768 wide, 12 layers, 12 heads,
  FFN 3072) as the diffusion's audio encoder through ``port-wav2vec2`` →
  ``train-diffusion --wav2vec2-checkpoint`` → ``sample-diffusion`` at the
  ``DiffusionConfig`` defaults (its attention is K2 by the tensor-core
  route, bf16, T′ = 12) and alone on a 10.24 s wave (T′ = 511: K3, sm90);
  AV-HuBERT base and the character seq2seq lip expert as the GAN's frozen
  lip expert (``port-avhubert``, ``train-lip-expert``, ``train-gan
  --avhubert-checkpoint`` / ``--lip-expert-checkpoint`` at the ``GanConfig``
  defaults; float32 experts: K2 by the CUDA-core route, causal in the
  expert's decoder);
- the DenseNet feature path: DenseNet121 at the published widths (growth
  32, blocks (6, 12, 24, 16), 1024 features) through ``port-densenet`` and
  ``embed_frames``, then the ``FeatureTransformer`` at the
  ``FeatureTransformerConfig`` defaults (1024 features, 2 heads, 2 layers,
  float32) through ``train-feature-transformer``, synthetic and from drawn
  LRS2-style records; the DenseNet is cuDNN's convolutions, BatchNorm and
  pooling (XLA's in the JAX package), the transformer's attention K2 at
  head dim 512 by its CUDA-core route, the records' ROIs K1;
- the multi-GPU story on the one card: torchrun at world size 1 under NCCL,
  and two gloo ranks sharing the card running data-parallel diffusion
  training with ZeRO-1, int8 lip-sync serving, ViViT serving, ring
  attention at the U-Net's full-resolution shape, the sequence-parallel and
  the pipelined ViViT (K1-K6 on each rank);
- the int8 lipreader (``predict_step_int8``: K6 once per Linear) and the K6
  microbench (``bench.microbench_int8``: both of K6's type pairs at 4096³).

Phases (each prints lines tagged with its name; any failure raises and the
script exits non-zero without printing a result):

1. device  — needs CUDA; prints the card, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build   — builds the kernels from ``csrc/*.cu`` with nvcc, one process
   per source; prints the build time, ptxas' register and shared-memory
   report and each kernel's dynamic shared memory.
3. kernels — each kernel against its plain torch version on the card
   (K1 CLAHE, on both routes, at the main path's and 23 more shapes, grids
   up to 17 x 17, 3 to 20,000 bins, clip 0.2, 2.0 and 2.5: its LUTs equal
   the plain version's and the output within 1e-2 gray levels where L is an
   integer and nbins a power of two, else LUTs within one level and output
   within 1 + 1e-2; the route and equal bits of two launches at each; then
   ``ops/image.clahe`` at grid (16, 16), 128 and 512 bins and 360 x 640
   frames; K2 small MHA: 2e-2 abs/rel in
   bf16 (the tensor-core kernel, also at S = 1, 16, 17 and 128, on qkv
   slices, and the CUDA-core kernel for unaligned views, d 18 and S past 128),
   1e-5 in float32 (the CUDA-core kernel at every float32 shape of the main
   paths: the word LM's (100, 31, 64), AV-HuBERT's, the seq2seq expert's and
   the FeatureTransformer's (64, 5, 1024) at head dim 512; and at its
   variants' edges: S 1, 8, 9, 32, 33, 64, 65 and 768, d 6, 132 and 600,
   views one element in), each with its route (and the CUDA-core kernel's
   variant) and equal bits of two launches, and
   its gradient at 1e-4 in float32; K3 flash
   forward: O within 1e-2 in bf16 (one output ulp at |O| ≤ 1; the
   tensor-core kernel also rounds P to bf16 before P·V, 2^-9 a term, and
   its error against the plain version that rounds P there is printed
   beside), 1e-4 in float32, lse within 1e-4; K4/K5 flash backward: each gradient within
   1e-2 of its largest value in bf16 (P and dS rounded to bf16 before the
   float32 sums, then one rounding of the gradient) against the plain
   version with float32 P, 1e-4 in float32; for K3, K4 and K5 aligned bf16
   inputs must take the tensor-core kernels and float32, unaligned ones or
   head dims above 256 the CUDA-core kernels, two launches must give equal
   bits, and head dims 320 and 512 and more than 65,535 (batch, head)
   pairs run forward and backward, and head dims 640 and 1024 (above 512 the
   CUDA-core kernels walk d in slices of 256) in float32 and bf16; K4/K5's
   CUDA-core launches each by the variant of ``csrc/flash_bwd.cu`` the case
   names ("tiled": every float32 case with 16-byte rows and d up to 256,
   the float32 U-Net's three shapes at 64 x 64 contiguous and as qkv slices
   among them; "general": a float32 view 4 bytes into its rows, bf16, d
   above 256); K6 matmul: int8 exactly equal, bf16 within 1e-3 of the
   largest |C| (the output is the unrounded float32 sum; only the order of
   summation differs), every serving shape and the tile edges by the
   tensor-core route, odd depths, a row-major int8 B and an unaligned view
   by the packed route (each operand a tensor map cannot read copied to
   K-major rows by ``csrc/int8_mm.cu``, then the same wgmma kernel; its
   packs counted), more than 65,535 x 64 columns, equal bits of two
   launches); K6's pack bit for bit against ``pack_reference`` in int8 and
   bf16 (the row-major shapes' A and B, an unaligned view, a broadcast A of
   row stride 0, the 4096² transposition), each by the path it must take;
   at the shapes the paths give them.
4. serve   — 3 requests of 8 clips and 3 of 384 clips (5 frames each, 96×96
   RGB uint8 frames and face boxes as in bench.py) through the main path,
   ``predict_frames``: host frames in, host log-probs out; every request
   must launch K1 once (by the packed route) and K2 once per layer (by the
   tensor-core route), and give finite log-probs; a ``torch.profiler``
   breakdown of a batch-384 request, with K1's device time; the batch-8
   requests (and their ROIs) must agree with the same model and inputs run
   on the CPU (the plain path). Then one batch-384 request through
   ``predict_step_int8``: K6 once per Linear (50, by the tensor-core
   route), K1 and K2 as before, held against ``predict_frames`` on the same
   frames, and its profile.
5. vivit-train — one ``train_step`` at the ``ViViTConfig`` defaults (8
   classes, batch 16, weights bridged from seeded numpy) on the card and on
   the CPU, in float32 (K2 12x by the CUDA-core route) and bf16 (12x by the
   tensor-core route): loss, logits, every gradient and every updated
   parameter compared (float32 1e-4, bf16 2e-2: loss relative, logits and
   each gradient of its tensor's largest, the key third of each qkv bias,
   whose gradient is exactly 0, aside, the whole gradient in relative L2;
   updated params off by at most 2·lr, and by more than 1e-6 only where the
   gradient is within that tolerance of 0, as an Adam step near a zero
   gradient may flip); K2's q/k/v gradients on
   block 0's (16, 80, 768) qkv views equal to autograd through
   ``_mha_einsum`` bit for bit; then ``cli.main(["train-vivit", "--steps",
   "128", "--set", "vivit.num_classes=8"])`` on the card: 4 epochs of 32
   steps, K2 12x a step and an eval batch all by the tensor-core route, a
   metric write at each step 1..128, the last epoch's mean loss below the
   first's, best accuracy above 1/8; then 20 steps at batch 16 and 10 at
   384 timed by CUDA events (batches on the card), peak memory, a profile
   of a step at each (busy share, K2 share).
6. lipread-e2e — ``lipreading_e2e.run`` (2 epochs) on 12 synthetic records of
   40 frames of 160×160 RGB (a drawn face) with transcripts over 24 words,
   fed from memory through ``read_frames``; each stage timed (detection,
   ROI, ViViT steps, eval, prediction, scorer fit, beam search); K1 once a
   clip by ``packed``, K2 by ``sm90`` 12× a ViViT step, eval batch and
   prediction, and by ``cuda_core`` 2× a word-LM step (400) and beam level
   (one a word), exactly (its variant ``rows_vec4``, as in ``pretrained``'s
   lip experts and ``features``' FeatureTransformer: those three phases log
   the CUDA-core launches by variant and fail without that one's);
   accuracies in [0, 1]; ``train_landmark.train``
   (48 steps, batch 64, width 32) and ``build_word_clip_dataset`` over 3
   records with its net (K1 once a clip); card against CPU: S3FD's 12 heads
   on a batch of 16 frames (1e-3 of each head's largest), record 0's face
   tracks (1e-2 px), its ROI from the same mouth boxes (max 2 levels, ≥ 99%
   within 1), word-LM scores of a 100-sentence beam level (1e-4).
7. diffuse — one warm-up and 3 timed ``sample_video`` requests of 4 frames
   × 10 DDIM steps, and one with DPM++(2M); each must launch K3 16 times a
   step (all by the tensor-core route) and K2 4 times, and return finite (4, 128, 128, 3) uint8 frames;
   a ``torch.profiler`` breakdown of one request (device busy share,
   K2/K3 shares); the full 500-step DDPM chain at batch 1; then the card against the CPU
   plain path at the full channel plan but 64×64, batch 1, 2 DDIM steps,
   same initial noise.
8. train   — ``train_step`` at the ``DiffusionConfig`` defaults, batch 8:
   one warm-up (eager) and 5 timed steps (a capture, then replays of the
   CUDA graph), each launching K3, K4 and K5 16 times and K2 4 times on the
   card, all by the tensor-core route (the warm-up counted by the wrappers,
   which count nothing in the graphed steps; 2 more replays by name in a
   device trace, ``_traced_launches``), with finite loss, params and EMA
   and an EMA that moves; a ``torch.profiler`` breakdown of one replayed
   step (device busy share, K2-K5 shares); 4 graphed steps against 4 eager
   ones from one seed (``check_train_graph``: t and noise equal to the bit,
   loss, params, EMA and Adam's moments equal wherever two eager runs are,
   a planted ``state_unchanged`` fault captured); 10
   steps on one batch with fixed t and noise must end below the first
   loss; one float32 step at the full channel plan but 64×64, batch 2,
   dropout 0, card against the CPU plain path (loss within 1e-4 relative,
   the whole gradient within 1e-3 relative L2), every K4/K5 launch of it by
   the "tiled" kernels of ``csrc/flash_bwd.cu``.
9. superres — 3 ``train_superres.train_step``s at the ``SuperResConfig``
   defaults, batch 8 (6 AttentionBlocks of 1024 tokens, d=192), then one
   ``sample_cascade`` request: base at ``DiffusionConfig(im_size=64)``, 4
   frames × 10 DDIM steps, SR 50 DDIM steps → finite (4, 128, 128, 3).
10. guidance — 5 ``train_classifier.train_step``s at the
   ``ClassifierConfig`` defaults on ``synthetic_batch`` (batch 32,
   128×128), then a guided ``sample_video`` of 4 frames × 10 DDIM steps
   (label 2, scale 5): K4/K5 twice a step.
11. data — builds ``csrc/prefetch_loader.cpp`` with g++ into the port's
   ``_build/`` (its path must lie under the port); a frame index
   (``build_frame_index`` through ``frame_count``) of 4 in-memory videos of
   48 drawn 160×160 frames at 25 fps with sidecar waves; 64 records of
   114,304 B at 128×128 (``DiffusionPairSampler`` through ``read_frames``,
   ``write_diffusion_records``), records/s; ``cli.main(["train-diffusion",
   "--records-root", ..., "--steps", "12", "--steps-per-dispatch", "4",
   "--checkpoint-every", "12"])`` at the ``DiffusionConfig`` defaults
   (batch 8), under a device trace: the native route, K2 52, K3 208, K4 and
   K5 192 each by name in the trace (16 a step, and the eval at step 12),
   all by ``sm90``; through the wrappers only the eager first step's and
   the eval's (the rest replay one CUDA graph); step times (the first apart),
   the share of the loop spent waiting on the feed, the first and last
   loss, the checkpoint's write time and size; ``cli.main(["sample-diffusion",
   "--checkpoint", ..., "--frames", "4", "--ddim-steps", "10"])``: 4 PNGs
   read back with ``zlib``, not constant, within 1 level of ``sample_video``
   on the same EMA params and seed, K2 4 and K3 160 by ``sm90``, load,
   sample and write times; ``pack-gan-records --synthetic`` (32) →
   ``train-gan --records-root --steps 8 --steps-per-dispatch 8`` at the
   ``GanConfig`` defaults by the native route: losses, feed waits.
12. lipsync — ``generate_frames`` on the serving bench's inputs (256 frames
   of 360×640, boxes [40,300,180,430] ± 4, standard-normal mels): one
   warm-up and 3 timed requests each in float, dynamic int8 and static
   int8; uint8 frames of the input's shape, untouched outside the boxes;
   K6 exactly once per convolution per batch in the int8 modes (51 × 2, all
   by the tensor-core route) and never in float; the generator's int8 output against its float output
   (PSNR); a batch-8 float request against the CPU; a profile of one
   dynamic int8 request (device busy share, device time by int8 stage).
13. flops   — ``utils/flops.flops_detail`` of one call of three paths, each
   counted on the card by the phase that times it, right after its timed
   runs (not timed again): a batch-384 ViViT request (K1 1, K2 12; also
   batch 8, whose model count must equal the same callable's on the CPU,
   where K2's products are the einsum path's), a batch-8 diffusion training
   step (K2 4, K3/K4/K5 16) and a 256-frame dynamic-int8 ``generate_frames``
   request (K6 102); each kernel launch of the counted call (the wrappers'
   ``launch_count`` deltas) must be in the count's records. Then
   ``mfu_report`` at each path's median: model and hw TFLOP, achieved
   TFLOP/s, MFU and HFU against the card's bf16 peak
   (``device_peak_tflops``, which must know the card), each kernel's share
   of the model count.
14. pretrained — random weights from seed 0 written in the published
   layouts: ``port-wav2vec2 --pth`` on a base ``Wav2Vec2ForCTC``-layout file
   → ``train-diffusion --wav2vec2-checkpoint --steps 4`` at the
   ``DiffusionConfig`` defaults (batch 8, bf16; K2 12, K3 16, K4/K5 16 a
   step and the eval at step 4, all sm90, by name in a device trace of the
   run, the eager first step and the eval also through the wrappers; the
   encoder's weights move) →
   ``sample-diffusion --checkpoint --frames 4 --ddim-steps 10`` (K2 12, K3
   160); a profile of a step; float32 card vs CPU: ``encode_condition`` at
   full width (1e-3) and a 64×64 step's loss (1e-4 relative) and wav2vec2
   gradients (1e-3 relative L2), its K4/K5 launches all by "tiled"; base
   wav2vec2 alone in bf16 on 163,840
   samples: K3 12× by sm90, each layer's O within 1e-2 of
   ``flash_reference``; ``port-avhubert --selftest``, ``port-avhubert
   --pth`` at base width → ``train-gan --avhubert-checkpoint --steps 4``
   (K2 24 a step by cuda_core); ``train-lip-expert --steps 8`` (K2 4 a
   step) → ``train-gan --lip-expert-checkpoint --steps 4`` on transcript
   batches (K2 4 a step); a float32 lip term card vs CPU (1e-4 relative;
   its gradient w.r.t. the generated window 1e-4, G's 1e-2 relative L2);
   each stage's wall time.
15. features — ``port-densenet --selftest``; DenseNet121 at full width,
   float32, card against CPU on its artifact (8 frames of 64×64, max|d| /
   max|f| within 1e-3); ``embed_frames`` on the CLI's 1,280 synthetic frames
   of 32×32 (frames/s, peak memory) and the forward on 64 frames of
   224×224 (time, peak memory, a profile: launches a batch); a
   ``FeatureTransformer`` train step at the defaults with dropout 0, card
   against CPU (loss 1e-5 relative, gradient 1e-4 relative L2; K2 2× by
   cuda_core), and K2's output scaled by 1.01 on the card, a fault the
   gradient gate must see; ``train-feature-transformer --synthetic`` (256
   clips, 38 held out, 60 steps: K2 exactly 122× by cuda_core, val accuracy,
   wall time of embedding and training); ``train-feature-transformer
   --data-root`` over 4 of ``lipread_records``' records from memory (K1 4×
   by packed, K2 2× a step and 2× in the eval, counts derived from the
   clips).
16. parallel — the multi-GPU story on the one card. World size 1 under NCCL:
   ``train-vivit --synthetic --steps 32`` and ``sample-diffusion --frames 2``
   at the defaults through ``python -m torch.distributed.run --standalone
   --nproc-per-node 1`` against the same commands run in this process
   without a process group (the ``best:`` line and the PNG bytes equal),
   then a NCCL group of one in this process, where every mesh entry point
   (``predict_sharded``, int8 ``generate_frames``, ``sample_video``, the
   diffusion, ViViT, GAN and super-resolution trainers,
   ``prefetch_to_device``) through ``build_mesh()`` equals
   ``mesh_spec=None`` bit for bit. Two gloo ranks sharing the card
   (``tests/torch_parallel_tasks.py``'s ``LocalGroup``; NCCL refuses two
   ranks on one device), each against one process's run saved to a file:
   a bf16 diffusion step at the ``DiffusionConfig`` defaults, global batch
   8 (4 a rank), two steps (ranks bit-equal, ZeRO-1 bit-equal to plain
   data parallelism, the first reduced gradient within
   ``TOL_PAR_GRAD_BF16`` of one process's, K3-K5 16 and K2 4 a step a
   rank, step times beside one process's, the share of a step in gloo's
   host transport; the diffusion runs go through the CPU tests' driver
   ``diffusion_dp``); a float32 step at 64×64
   whose reduced gradient must lie within ``TOL_PAR_GRAD`` of one
   process's, and the same with rank 1's gradient × 1.01 before the
   reduction, which must not (each rank's K4/K5 launches all by "tiled"); int8 ``generate_frames`` at width 1.0 (16
   frames of 360×640, K6 51 a rank); ``ring_attention`` at (1,4,16384,64)
   forward and backward, plain and causal, against
   ``attention_reference``; the ViViT defaults with ``sequence_parallel``
   against their local forward; the pipelined ViViT (2 stages, n_micro 2
   and 4, float32) against the canonical model's logits and gradients; a
   ViViT request whose ROIs (K1) and rows (K2) split over the ranks. Then
   tensor parallelism on the same two ranks as one data row of two model
   ranks, every model at full width: ``tp2_generate`` (``generate_frames``
   at the ``GanConfig`` defaults and the default threshold, where the
   decoder's two 512x1024x3x3 convs are sharded: int8 frames 0 levels and
   float frames within 1 of one process's, K6 51 a rank with its routes),
   ``tp2_gan`` (``train_gan.train`` at the defaults, bf16, batch 16, 2
   steps: the ranks' leaves equal, the primary's checkpoint holding the
   two convs and their Adam moments whole; a float32 step's gradients
   within ``TOL_TP_GAN_GRAD`` of one process's), ``tp2_diffusion`` (the
   ``DiffusionConfig`` defaults at threshold 2^16 from drawn params: 2
   bf16 steps, the first gradient within ``TOL_TP_GRAD_BF16`` of one
   process's on the leaves outside ``AUDIO_GATED``, K3-K5 16 and K2 4 a
   step a rank, and a float32 step at 64x64 within ``TOL_TP_GRAD`` on
   all leaves, its K4/K5 launches all by "tiled"), ``tp2_serve`` (``predict_sharded`` at the ViViT
   defaults, threshold 2^16, the caller's model unchanged, K1 1 and K2 12
   a rank) and ``tp2_cli`` (``cli.main(["sample-diffusion", "--frames",
   "2", ..., "--set", "mesh.model_parallel=2", ...])`` in each rank: the
   PNGs written by the primary alone); each gate written ``not (x <=
   tol)`` and held below a planted fault's reading in the same run (rank
   1's slice of a sharded leaf, or its gradient, x 1.01), each case's
   bytes of params, EMA and Adam moments a rank against one process's.
   Each run's backend and each rank's launches are printed.
17. microbench — ``bench.microbench_int8.run``: K6 in bf16 and in int8
   (B row-major, route "packed": one pack of B a product, and B a (N, K)
   weight transposed) and the library's calls on the same operands at
   4096³, after its own checks; then ``ops.quant.int8_dense`` at the ViViT's
   (30720, 256) x (256, 768) on the card equal to its CPU plain path, with
   one pack and one wgmma product.
18. timing — request and train-step times, frames/s, each kernel's
   CUDA-event time beside its plain version's at the main-path shapes, the
   one PyTorch call that computes the same function where there is one
   (``scaled_dot_product_attention`` and its backward, at all three U-Net
   shapes beside K3 and beside K4 + K5, ``torch._int_mm``,
   ``torch.matmul``; yardsticks, used on no path), each kernel's bound
   (the larger of its bytes over 3.35 TB/s and its operations over the
   tensor-core peak of its type, or 67 TFLOP/s in float32 outside them) and
   its share of it, K1, K2, K3 and K6 also through their C entry points in
   a loop (without the wrappers' host work), and K1 on 64 frames of 360 x
   640 (its tiled route). K2's CUDA-core route at the five float32 shapes
   of the main paths (``bench/small_mha_timing.py``): through ``small_mha``,
   its C entry point in a loop and from a CUDA graph of 20 launches, beside
   SDPA float32 from a CUDA graph of 20 calls; the float32 CUDA-core K3 at
   (2, 1, 4096, 64), the float32 U-Net's at 64 x 64, beside SDPA float32's
   forward; K4/K5's CUDA-core kernels in both variants at the float32
   U-Net's three shapes at 64 x 64 and (2, 1, 16384, 64)
   (``bench/flash_bwd_timing.py``): each variant's C entry point from a CUDA
   graph of 20 launches, "tiled" also through the wrappers (launches
   counted by variant), the plain version, SDPA float32's backward from a
   CUDA graph where its capture works, and the library kernel it runs.

The line before the last is ``nvidia-smi``'s name and power limit; before
it, one JSON object with the kernels; the last line is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# TF32 flags of a freshly started process, before ``phase_device`` turns
# TF32 off: the in-process runs held against a ``python -m ...cli`` process
# run with these
FRESH_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

SEED = 0
TOL_K1 = 1e-2        # gray levels: exact LUTs, float32 blend rounding only
TOL_K2_BF16 = 2e-2   # one bf16 rounding of P and of O, sums in another order
TOL_K2_F32 = 1e-5
TOL_GRAD = 1e-4
# bf16 card vs bf16 CPU through 12 blocks (other summation order, other
# bf16 rounding points) on ROIs that may differ by a gray level here and
# there: logits agree within 5e-2 abs + 5e-2 relative.
TOL_LOGITS = 5e-2
CLIP_FRAMES = 5
TOL_K3_BF16 = 1e-2   # float32 inside on both sides; O may round to the next bf16
TOL_K3_F32 = 1e-4
TOL_LSE = 1e-4
# bf16 card (cuDNN convs, K3, K2) vs bf16 CPU (other conv and GEMM kernels,
# plain attention) through 2 DDIM steps of the 64×64 U-Net: bf16 rounds at
# other points on each side; frames in [0, 1] agree within 2e-2 (3.8e-3
# measured on an H100).
TOL_FRAMES = 2e-2
DIFF_FRAMES, DIFF_STEPS = 4, 10
# K4/K5 against flash_backward_reference: max|d| over the largest |gradient|.
# float32 inside on both sides, sums in another order; in bf16 each gradient
# is rounded once (2^-8 of the value).
TOL_BWD_BF16 = 1e-2
TOL_BWD_F32 = 1e-4
TRAIN_BATCH = 8
# float32 train step, card (cuDNN without TF32, K3/K4/K5) vs CPU (plain):
# summation order only, through ~90 layers and their backward.
TOL_TRAIN_LOSS = 1e-4      # relative
TOL_TRAIN_GRAD = 1e-3      # relative L2 of the whole gradient
# K6 bf16 against a float32 matmul of the same bf16 values: exact products,
# float32 sums in another order; of the largest |C|. int8 must be equal.
TOL_K6_BF16 = 1e-3
# int8 ViViT against the bf16 one on the same ROIs (tests/test_quant.py's
# bounds for the JAX package's tiny float32 model).
INT8_TOP1_AGREE = 0.9
INT8_LOGPROB = 0.25
# int8 generator output in [0, 1] against the float output, same weights
# (tests/test_quant.py's bounds: dynamic 30 dB, static 28 dB).
PSNR_DYNAMIC, PSNR_STATIC = 30.0, 28.0
LIPSYNC_FRAMES, LIPSYNC_HW = 256, (360, 640)
# float32 generator, card (cuDNN without TF32) vs CPU: summation order only,
# so a frame value moves by at most one gray level, and rarely.
LIPSYNC_EQUAL_SHARE = 0.999
# H100 SXM peaks the bounds are stated against (NVIDIA's data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}   # f32: outside the tensor cores


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_name_power()
    # Full float32 matmuls and convolutions in every plain version.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{name}; device_count={torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 off")
    return {"name": name, "count": torch.cuda.device_count(), "smi": smi}


def phase_build() -> None:
    from lipreading_video_generation_tpu_torch.ops import _build

    lib = _build.build(force=True)
    _build.load()
    log("build", f"{lib} from {[p.name for p in _build.sources()]} in "
        f"{_build.build_info['seconds']:.1f} s")
    notes = 0
    for line in str(_build.build_info["log"]).splitlines():
        if "(C75" in line:      # ptxas' notes on the wgmma kernels: counted, not listed
            notes += 1
        elif ("ptxas info" in line and ("registers" in line or "Compiling" in line
                                        or "smem" in line)) or "spill" in line or "arning" in line:
            log("build", line.strip())
    log("build", f"{notes} ptxas notes (C75xx: a warpgroup.arrive or warpgroup.wait injected around "
        "the asynchronous products)")
    from lipreading_video_generation_tpu_torch.ops.attention import (
        _small_mha_smem_bytes, flash_bwd_smem_bytes, flash_smem_bytes)

    from lipreading_video_generation_tpu_torch.ops.clahe_cuda import clahe_packed_layout

    log("build", f"dynamic shared memory per block at the main-path shapes: K1 packed route "
        f"{clahe_packed_layout(48, 48, (8, 8), 256)['smem']} B (8x8 tiles of 256 8-bit counters, "
        "2,304 bins, row and column tables), K2 CUDA-core route: in its rows variants (S <= "
        "64, every float32 main-path shape) K and V of a block's pairs, 8 s d B a pair: "
        f"{8 * 5 * 512} B (S=5, d=512), {8 * 48 * 64} B (S=48, d=64); in its general ones "
        f"{_small_mha_smem_bytes(80, 32)} B (S=80, d=32), "
        f"{_small_mha_smem_bytes(768, 32)} B (S=768, d=32)"
        + "".join(f"; K3 {what} " + ", ".join(
            f"{flash_smem_bytes(d, route, variant)} B (head dim {d})" for d in dims)
            for route, variant, what, dims in (
                ("sm90", "general", "tensor-core route (bf16 tiles)", (64, 128, 256)),
                ("cuda_core", "general", "CUDA-core route, general variant (float tiles)",
                 (64, 128, 256, 512, 1024)),
                ("cuda_core", "tiled", "CUDA-core route, tiled variant (float tiles, two stages "
                 "of K and V)", (64, 128, 256))))
        + "".join(f"; {name} {what} " + ", ".join(
            f"{flash_bwd_smem_bytes(d, kern, route, variant)} B (head dim {d})" for d in dims)
            for route, variant, what, dims in (
                ("sm90", "general", "tensor-core route (bf16 tiles)", (64, 128, 256)),
                ("cuda_core", "general", "CUDA-core route, general variant (float tiles)",
                 (64, 128, 256, 512, 1024)),
                ("cuda_core", "tiled", "CUDA-core route, tiled variant (float tiles, two "
                 "stages of the streamed pair)", (64, 128, 256)))
            for name, kern in (("K4", "dkv"), ("K5", "dq")))
        + "; K6 tensor-core route 4 stages of (128 + N tile) rows of 128 bytes, their 8 "
        "mbarriers + 1 KB: "
        + ", ".join(f"{4 * (128 + bn) * 128 + 1024 + 64} B (N tile {bn})" for bn in (8, 64, 256))
        + ", pack 16384 B static (a tile of 128 depths x 128 bytes); K2 tensor-core route "
        "two buffers of Q, K, V rows of 2 d_pad + 16 bytes: "
        f"{2 * 3 * 80 * (2 * 32 + 16)} B (S=80, d=32), {2 * 3 * 16 * (2 * 128 + 16)} B (S=11, d=96)")


def _uniform(shape, lo, hi, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(
        "cuda", dtype)


# K1 cases (shape, grid, nbins, clip, route, most LUT entries that may
# differ): the main path's and the first card check's two; the packed
# route's edges (16 x 16 tiles, 128 and 8 bins, clip 2.0 where L is still 1,
# 121 pixels a tile where area * nbins^2 is just below 2^23); the CPU tests'
# (512 bins, tiles of 4,096 and 920 pixels, clip 0.2, 2.0 and 2.5), frames of
# 360 x 640, and the tiled route's edges: padding that spans more than the
# last tile, 20,000 bins (three passes of 8,192), 17 x 17 tiles, 100 and 3
# bins, a single pixel, integer L above 1 (exact sums: equal LUTs), clip 10.
# Where L is not an integer or nbins not a power of two a level next to a
# rounding tie may move by one: the last entry bounds how many do, at twice
# the most that seeds 0-3 gave on the card, plus 2 (PERF.md, §6)
K1_CASES = [((1920, 48, 48), (8, 8), 256, 0.2, "packed", 0), ((3, 50, 46), (8, 8), 256, 0.2, "tiled", 0),
            ((2, 64, 64), (4, 4), 256, 0.2, "tiled", 0), ((2, 64, 64), (4, 4), 256, 2.5, "tiled", 2),
            ((5, 48, 48), (8, 8), 256, 2.0, "packed", 0), ((2, 48, 48), (16, 16), 256, 0.2, "packed", 0),
            ((2, 48, 48), (16, 16), 256, 2.0, "packed", 0), ((2, 48, 48), (8, 8), 128, 0.2, "packed", 0),
            ((2, 48, 48), (8, 8), 8, 0.2, "packed", 0), ((2, 88, 88), (8, 8), 256, 0.2, "packed", 0),
            ((2, 48, 48), (8, 8), 512, 2.5, "tiled", 0), ((2, 128, 128), (2, 2), 256, 2.5, "tiled", 0),
            ((2, 128, 128), (2, 2), 256, 0.2, "tiled", 2), ((1, 180, 320), (8, 8), 256, 2.0, "tiled", 2),
            ((1, 180, 320), (8, 8), 256, 0.2, "tiled", 0), ((2, 360, 640), (8, 8), 256, 0.2, "tiled", 2),
            ((2, 360, 640), (8, 8), 256, 2.5, "tiled", 2), ((3, 5, 5), (4, 4), 256, 0.2, "tiled", 0),
            ((2, 48, 48), (8, 8), 20000, 0.2, "tiled", 135110), ((2, 48, 48), (17, 17), 256, 2.0, "tiled", 0),
            ((2, 48, 48), (8, 8), 100, 0.2, "tiled", 116), ((2, 48, 48), (8, 8), 3, 2.0, "tiled", 2),
            ((2, 1, 1), (1, 1), 256, 0.2, "tiled", 0), ((2, 49, 47), (3, 5), 256, 2.0, "tiled", 2),
            ((2, 48, 48), (8, 8), 8, 2.0, "tiled", 0), ((2, 64, 64), (4, 4), 16, 2.0, "tiled", 0),
            ((2, 48, 48), (8, 8), 256, 10.0, "tiled", 2)]


def k1_exact(shape, grid, nbins: int, clip: float) -> bool:
    """True where L is an integer and nbins a power of two: every partial sum
    of the CDF is exact, whatever the order of the sums."""
    th, tw = -(-shape[-2] // grid[0]), -(-shape[-1] // grid[1])
    limit = float(np.float32(max(1.0, clip * th * tw / nbins)))
    return limit.is_integer() and nbins & (nbins - 1) == 0


def check_clahe() -> float:
    """K1 at every case of ``K1_CASES`` against the plain version: the route,
    equal bits over two launches, and the LUTs (``clahe_cuda(luts=...)``
    against ``clahe_luts_reference``). Where the sums are exact
    (``k1_exact``) the LUTs must be equal and the output within TOL_K1.
    Elsewhere every LUT entry within 1 level, no more entries off than the
    case allows, and the output within 1 + TOL_K1. Then images that do not
    start on 16 bytes (the tiled route), and ``ops/image.clahe`` at shapes
    the one-block-an-image kernel refused. Returns the largest |d| of the
    exact cases."""
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops import image as im

    worst = 0.0
    for shape, grid, nbins, clip, route, max_diff in K1_CASES:
        x = _uniform(shape, 0, 255, SEED)
        if cl.clahe_route(shape[1], shape[2], grid, nbins, clip) != route:
            raise AssertionError(f"K1 {shape} {grid} {nbins} clip {clip}: route "
                                 f"{cl.clahe_route(shape[1], shape[2], grid, nbins, clip)}, "
                                 f"want {route}")
        luts = torch.empty(shape[0], grid[0] * grid[1], nbins, device="cuda")
        before = dict(cl.clahe_cuda.route_counts)
        got = cl.clahe_cuda(x, clip, grid, nbins, luts=luts)
        again = cl.clahe_cuda(x, clip, grid, nbins)
        torch.cuda.synchronize()
        took = {r: n - before[r] for r, n in cl.clahe_cuda.route_counts.items() if n != before[r]}
        if took != {route: 2}:
            raise AssertionError(f"K1 {shape} {grid} {nbins}: routes {took}, want {route}")
        if not torch.equal(got, again):
            raise AssertionError(f"K1 {shape} {grid} {nbins}: two launches gave different bits")
        exact = k1_exact(shape, grid, nbins, clip)
        if exact != (max_diff == 0):
            raise AssertionError(f"K1 {shape} {grid} {nbins} clip {clip}: the case's bound "
                                 f"{max_diff} does not fit its sums (exact: {exact})")
        err = (got - cl.clahe_reference(x, clip, grid, nbins)).abs().max().item()
        lut_d = (luts - cl.clahe_luts_reference(x, clip, grid, nbins)).abs()
        n_diff, lut_err = int((lut_d > 0).sum().item()), lut_d.max().item()
        tol = TOL_K1 if exact else 1 + TOL_K1
        log("kernels", f"K1 clahe {shape} grid {grid} nbins {nbins} clip {clip}"
            f"{' (exact sums)' if exact else ''}, route {route}: max|d| {err:.3g} (tol {tol}); "
            f"LUT entries that differ {n_diff} of {lut_d.numel()} (at most {max_diff}), by at "
            f"most {lut_err:g} (want {'0' if exact else '<= 1'}); two launches equal bits")
        if not (err <= tol and lut_err <= (0 if exact else 1) and n_diff <= max_diff):
            raise AssertionError(f"K1 {shape} {grid} {nbins} clip {clip}: max|d| {err}, LUT "
                                 f"{lut_err}, {n_diff} entries differ (at most {max_diff})")
        if exact:
            worst = max(worst, err)
    # an image that does not start on 16 bytes: the packed route reads float4s
    base = _uniform((2 * 48 * 48 + 1,), 0, 255, SEED)
    x = base[1:].view(2, 48, 48)
    before = dict(cl.clahe_cuda.route_counts)
    got = cl.clahe_cuda(x, 0.2, (8, 8))
    err = (got - cl.clahe_reference(x, 0.2, (8, 8))).abs().max().item()
    if cl.clahe_cuda.route_counts["tiled"] != before["tiled"] + 1 or not err <= TOL_K1:
        raise AssertionError(f"K1 on images at an odd address: routes "
                             f"{cl.clahe_cuda.route_counts}, max|d| {err}")
    # ops/image.clahe on the card at shapes the one-block-an-image kernel refused
    for shape, kw in (((2, 48, 48), {"grid": (16, 16)}), ((2, 48, 48), {"nbins": 128}),
                      ((2, 48, 48), {"nbins": 512}), ((2, 360, 640), {})):
        x = _uniform(shape, 0, 255, SEED + 1).round().to(torch.uint8)
        got = im.clahe(x, **kw)
        want = cl.clahe_reference(x, **kw)
        if got.dtype != torch.uint8 or (got.int() - want.int()).abs().max().item() > 1:
            raise AssertionError(f"im.clahe {shape} {kw}: dtype {got.dtype}, off the plain version")
    log("kernels", "K1 on images 4 bytes off 16: route tiled, max|d| "
        f"{err:.3g}; im.clahe on the card at grid (16, 16), nbins 128 and 512, and (2, 360, 640): "
        "uint8 out, within one level of the plain version (rounding of the float32 blend)")
    return worst


def phase_kernels() -> dict:
    from lipreading_video_generation_tpu_torch.bench import flash_fwd_timing
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl

    errs = {"clahe": check_clahe(), "small_mha": 0.0, "flash_attention": 0.0}

    # K2: the ViViT's, the audio encoder's and a causal shape in bf16 (the
    # tensor-core kernel) and float32 (the CUDA-core kernel); the tensor-core
    # kernel's edges: S = 1, 16, 17 and 128 (its largest), causal and not, head
    # dims 8, 64 and 128, more heads than blocks at once; column slices of one
    # qkv tensor, as the models pass them; a bf16 view that starts 8 bytes
    # into its rows, which 16-byte copies cannot read (CUDA-core kernel). The
    # kind is "sm90" or the variant of csrc/small_mha.cu that the CUDA-core
    # route must take ("off1": views that start one element into their rows)
    bf16, f32 = torch.bfloat16, torch.float32
    k2_cases = [(384, 80, 256, 8, False, bf16, "sm90", ""),
                (DIFF_FRAMES, 11, 768, 8, False, bf16, "sm90", ""),         # audio encoder
                (2, 33, 64, 4, True, bf16, "sm90", ""),
                (2, 33, 64, 4, True, f32, "rows_vec4", ""),
                (384, 80, 256, 8, False, bf16, "sm90", "qkv"),
                (3, 33, 64, 4, True, bf16, "rows", "unaligned")]
    k2_cases += [(3, s, 64, 4, causal, bf16, "sm90", "")
                 for s in (1, 16, 17) for causal in (False, True)]
    k2_cases += [(2, 128, 256, 4, causal, bf16, "sm90", "") for causal in (False, True)]
    k2_cases += [(2, 128, 256, 2, True, bf16, "sm90", ""), (5, 40, 16, 2, False, bf16, "sm90", ""),
                 (3000, 16, 64, 4, True, bf16, "sm90", ""),
                 (2, 160, 64, 1, False, bf16, "general", "")]                # S past 128
    # the pretrained encoders: wav2vec2 at 4,000 samples (bf16), AV-HuBERT
    # and the conformer at T 5 (float32), the expert's causal decoder on its
    # fused qkv (float32), at the batches of [pretrained]
    k2_cases += [(TRAIN_BATCH, 12, 768, 12, False, bf16, "sm90", ""),
                 (16, 5, 768, 12, False, f32, "rows_vec4", ""),
                 (16, 5, 256, 4, False, f32, "rows_vec4", ""),
                 (16, 5, 256, 4, False, f32, "rows_vec4", "qkv"),
                 (16, 48, 256, 4, True, f32, "rows_vec4", "qkv")]
    # the FeatureTransformer at its defaults: 1024 features, 2 heads (head
    # dim 512), float32, on its fused qkv, at the CLI's batch; the word LM's
    # causal (B <= 100, 31, 64), 4 heads, on its fused qkv
    k2_cases += [(64, 5, 1024, 2, False, f32, "rows_vec4", "qkv"),
                 (100, 31, 64, 4, True, f32, "rows_vec4", "qkv")]
    # the CUDA-core variants' edges: S 1, 8/9, 32/33, 64/65 (the rows
    # kernel's register room for scores, then the general kernel), d 6, 512
    # at S 33, views one element in (element loads), d past 128 / 512 there,
    # one head of 768 tokens, the float32 ViViT's S 80
    k2_cases += [(3, 1, 64, 4, False, f32, "rows_vec4", ""),
                 (3, 8, 256, 4, True, f32, "rows_vec4", "qkv"),
                 (3, 9, 256, 4, False, f32, "rows_vec4", ""),
                 (3, 32, 64, 4, True, f32, "rows_vec4", "qkv"),
                 (3, 64, 256, 4, True, f32, "rows_vec4", ""),
                 (2, 65, 64, 4, True, f32, "general_vec4", "qkv"),
                 (3, 5, 24, 4, True, f32, "rows", ""),
                 (2, 33, 1024, 2, True, f32, "rows_vec4", ""),
                 (3, 48, 256, 4, True, f32, "rows", "off1"),
                 (3, 33, 72, 4, False, bf16, "rows", "off1"),
                 (2, 5, 528, 4, False, f32, "general", "off1"),
                 (2, 5, 2400, 4, False, f32, "general_vec4", "qkv"),
                 (1, 768, 32, 1, True, f32, "general_vec4", ""),
                 (4, 80, 256, 8, False, f32, "general_vec4", "qkv")]
    for (b, s, e, h, causal, dtype, kind, layout) in k2_cases:
        tol = TOL_K2_BF16 if dtype == bf16 else TOL_K2_F32
        route = "sm90" if kind == "sm90" else "cuda_core"
        if layout == "qkv":
            q, k, v = _uniform((b, s, 3 * e), -2, 2, SEED, dtype).chunk(3, dim=-1)
        elif layout == "unaligned":
            q, k, v = (_uniform((b, s, e + 8), -2, 2, SEED + i, dtype)[..., 4:4 + e]
                       for i in range(3))
        elif layout == "off1":
            q, k, v = (_uniform((b, s, e + 4), -2, 2, SEED + i, dtype)[..., 1:1 + e]
                       for i in range(3))
        else:
            q, k, v = (_uniform((b, s, e), -2, 2, SEED + i, dtype) for i in range(3))
        before = dict(att.small_mha.route_counts)
        before_v = dict(att.small_mha.variant_counts)
        got = att.small_mha(q, k, v, h, causal)
        again = att.small_mha(q, k, v, h, causal)
        torch.cuda.synchronize()
        took = {r: n - before[r] for r, n in att.small_mha.route_counts.items() if n != before[r]}
        took_v = {r: n - before_v[r] for r, n in att.small_mha.variant_counts.items()
                  if n != before_v[r]}
        if took != {route: 2} or took_v != ({} if kind == "sm90" else {kind: 2}):
            raise AssertionError(f"K2 ({b},{s},{e}) H={h} {dtype} {layout}: routes {took}, "
                                 f"variants {took_v}, want {kind}")
        if not torch.equal(got, again):
            raise AssertionError(f"K2 ({b},{s},{e}) H={h} {dtype}: two launches gave different bits")
        want = att._mha_einsum(q, k, v, h, causal)
        err = (got.float() - want.float()).abs().max().item()
        log("kernels", f"K2 small_mha ({b},{s},{e}) H={h} causal={causal} {dtype}"
            f"{' (' + layout + ')' if layout else ''}, route {route}"
            f"{'' if kind == 'sm90' else ', variant ' + kind}: "
            f"max|d| {err:.3g} (tol {tol} abs/rel); two launches equal bits")
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        errs["small_mha"] = max(errs["small_mha"], err)

    q, k, v = (_uniform((2, 33, 64), -2, 2, SEED + 10 + i).requires_grad_() for i in range(3))
    cot = _uniform((2, 33, 64), -1, 1, SEED + 13)
    (att.small_mha(q, k, v, 4) * cot).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (att._mha_einsum(*ref, 4, False) * cot).sum().backward()
    torch.cuda.synchronize()
    for t, r in zip((q, k, v), ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=TOL_GRAD, atol=TOL_GRAD)
    log("kernels", f"K2 small_mha gradient (2,33,64) H=4 f32 matches autograd "
        f"through _mha_einsum (tol {TOL_GRAD})")

    # small causal / ragged / cross / fully-masked-row shapes (q, s_k, causal)
    small = [((2, 3, 192, 32), 192, True), ((2, 3, 160, 40), 320, True),
             ((2, 3, 200, 16), 200, False), ((1, 2, 160, 128), 320, False),
             ((1, 2, 256, 256), 256, True), ((1, 2, 200, 64), 150, True)]
    # head dims above 256 (the CUDA-core kernels in both types, at the tokens
    # a U-Net block of 512 channels has at ds 4; above 512 the sliced
    # kernels, d = 640 as JAX pads it to 768 and d = 1024, causal and
    # ragged too) and more than 65,535 (batch, head) pairs (one case a route)
    wide_heads = [((1, 1, 1024, d), 1024, False, dt, "cuda_core")
                  for d in (320, 512, 640, 1024) for dt in (f32, bf16)]
    wide_heads += [((1, 2, 300, d), 260, True, dt, "cuda_core")
                   for d in (640, 1024) for dt in (f32, bf16)]
    many_heads = [((4097, 17, 132, 16), 132, True, bf16, "sm90"),
                  ((2048, 33, 132, 16), 132, False, f32, "cuda_core")]

    def flash_inputs(q_shape, s_k, dtype, layout, seed):
        """q, k, v and a cotangent. ``layout`` "unaligned": columns 4..d+3 of
        rows of d + 8, a view that starts 8 bytes into its rows (bf16);
        "off4": columns 1..d of rows of d + 4, 4 bytes in (float32); "qkv":
        (B, H, S, D) views of column slices of one (B, S, 3 H D) tensor, as
        the U-Net passes them (s_k = s_q); "": contiguous."""
        b, h, s_q, d = q_shape
        if layout == "qkv":
            qkv = _uniform((b, s_q, 3 * h * d), -2, 2, seed, dtype)
            q, k, v = (t.reshape(b, s_q, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
            do = _uniform((b, s_q, h * d), -1, 1, seed + 3, dtype)
            return [q, k, v, do.reshape(b, s_q, h, d).transpose(1, 2)]
        start, pad = {"unaligned": (4, 8), "off4": (1, 4)}.get(layout, (0, 0))
        q = _uniform((b, h, s_q, d + pad), -2, 2, seed, dtype)
        k, v = (_uniform((b, h, s_k, d + pad), -2, 2, seed + 1 + i, dtype) for i in range(2))
        do = _uniform((b, h, s_q, d + pad), -1, 1, seed + 3, dtype)
        return [t[..., start:start + d] if pad else t for t in (q, k, v, do)]

    # K3: the U-Net's three shapes (batch 2), scripts/profile_flash_dpad.py's
    # two, the small cases in float32 (the CUDA-core kernel) and in bf16 (the
    # tensor-core kernel), a bf16 view that starts 8 bytes into its rows,
    # which 16-byte copies cannot read (it must take the CUDA-core kernel),
    # head dims 320 and 512, and more than 65,535 (batch, head) pairs. The
    # float32 cases name the variant of csrc/flash_fwd.cu they must take:
    # "tiled" for the float32 U-Net's three shapes at 64x64 and its heaviest
    # at 128x128, contiguous and as slices of its fused qkv (the two smaller
    # split the key axis, and the combine kernel joins the splits), the
    # small cases (causal with s_q < s_k, ragged, rows that see no key) and
    # more than 65,535 pairs; "general" for a float32 view 4 bytes into its
    # rows and above head dim 256. (q, s_k, causal, dtype, route, variant of
    # the CUDA-core route or None, layout of flash_inputs)
    cc = "cuda_core"
    k3_cases = ([((2, 1, 16384, 64), 16384, False, bf16, "sm90", None, ""),
                 ((2, 1, 4096, 128), 4096, False, bf16, "sm90", None, ""),
                 ((2, 1, 1024, 256), 1024, False, bf16, "sm90", None, ""),
                 ((1, 1, 16384, 64), 16384, False, bf16, "sm90", None, ""),
                 ((1, 1, 512, 64), 512, False, f32, cc, "tiled", ""),
                 ((1, 12, 511, 64), 511, False, bf16, "sm90", None, "")]   # wav2vec2, 10.24 s
                + [((2, 1, s, d), s, False, f32, cc, "tiled", layout)
                   for s, d in ((4096, 64), (1024, 128), (256, 256), (16384, 64))
                   for layout in ("", "qkv")]
                + [c + (f32, cc, "tiled", "") for c in small]
                + [c + (bf16, "sm90", None, "") for c in small]
                + [((2, 2, 300, 64), 300, True, bf16, cc, "general", "unaligned"),
                   ((2, 2, 300, 64), 300, True, f32, cc, "general", "off4")]
                + [c + ("general", "") for c in wide_heads]
                + [c + ("tiled" if c[3] == f32 else None, "") for c in many_heads])
    errs["flash_fwd_combine"] = 0.0
    for (q_shape, s_k, causal, dtype, route, variant, layout) in k3_cases:
        q, k, v, _ = flash_inputs(q_shape, s_k, dtype, layout, SEED)
        b, h, s_q, d = q_shape
        splits = att.flash_fwd_splits(b * h, s_q, s_k, d) if variant == "tiled" else 1
        before = dict(att.flash_attention.route_counts)
        before_v = dict(att.flash_attention.variant_counts)
        combined = att.flash_fwd_combine.launch_count
        got_o, got_lse = att.flash_attention(q, k, v, causal, return_lse=True)
        again_o, again_lse = att.flash_attention(q, k, v, causal, return_lse=True)
        torch.cuda.synchronize()
        took = {r: n - before[r] for r, n in att.flash_attention.route_counts.items()
                if n != before[r]}
        took_v = {v_: n - before_v[v_] for v_, n in att.flash_attention.variant_counts.items()
                  if n != before_v[v_]}
        if (took != {route: 2} or took_v != ({} if variant is None else {variant: 2})
                or att.flash_fwd_combine.launch_count != combined + 2 * (splits > 1)):
            raise AssertionError(f"K3 q{q_shape} {dtype} {layout}: routes {took}, variants "
                                 f"{took_v}, combines {att.flash_fwd_combine.launch_count - combined}"
                                 f", want {route} {variant} ({splits} splits)")
        if not (torch.equal(got_o, again_o) and torch.equal(got_lse, again_lse)):
            raise AssertionError(f"K3 q{q_shape} {dtype}: two launches gave different bits")
        want_o, want_lse = att.flash_reference(q, k, v, causal)
        err = (got_o.float() - want_o.float()).abs().max().item()
        err_lse = (got_lse - want_lse).abs().max().item()
        # float32 P on both sides, or (tensor-core route) P rounded to bf16
        # before P.V: 2^-9 relative a term, averaging out over a row, under
        # the one rounding of O to bf16 that both carry
        tol = TOL_K3_BF16 if dtype == torch.bfloat16 else TOL_K3_F32
        note = ""
        if route == "sm90":
            want_p, _ = att.flash_reference(q, k, v, causal, p_dtype=torch.bfloat16)
            note = (f"; against the plain version with bf16 P "
                    f"{(got_o.float() - want_p.float()).abs().max().item():.3g}")
            del want_p
        if splits > 1:
            # the combine kernel through its wrapper, on the partials the tiled
            # kernel wrote for these inputs, against its plain version
            launch = flash_fwd_timing.c_entry_launcher(att, q, k, v, causal, n_split=splits)
            launch()
            comb_o, comb_lse = att.flash_fwd_combine(*launch.parts)
            torch.cuda.synchronize()
            ref_o, ref_lse = att.flash_combine_reference(*launch.parts)
            c_err = max((comb_o - ref_o).abs().max().item(),
                        (comb_lse - ref_lse).abs().max().item())
            note += (f"; {splits} key splits, the combine kernel on them against "
                     f"flash_combine_reference max|d| {c_err:.3g} (tol {TOL_K3_F32} abs/rel)")
            torch.testing.assert_close(comb_o, ref_o, rtol=TOL_K3_F32, atol=TOL_K3_F32)
            torch.testing.assert_close(comb_lse, ref_lse, rtol=TOL_LSE, atol=TOL_LSE)
            errs["flash_fwd_combine"] = max(errs["flash_fwd_combine"], c_err)
            del launch, comb_o, comb_lse, ref_o, ref_lse
        log("kernels", f"K3 flash_attention q{q_shape} s_k={s_k} causal={causal} {dtype}"
            + {"unaligned": " (view 8 bytes into its rows)", "off4": " (view 4 bytes into its "
               "rows)", "qkv": " (slices of one qkv)"}.get(layout, "")
            + f", route {route}{'' if variant is None else ', variant ' + variant}: "
            f"O max|d| {err:.3g} (tol {tol} abs/rel){note}, lse max|d| {err_lse:.3g} "
            f"(tol {TOL_LSE} abs/rel); two launches equal bits")
        torch.testing.assert_close(got_o.float(), want_o.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(got_lse, want_lse, rtol=TOL_LSE, atol=TOL_LSE)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        del q, k, v, got_o, got_lse, again_o, again_lse, want_o, want_lse

    # K4/K5: the U-Net's three shapes (batch 2), the super-resolution U-Net's
    # (d=192, padded to 256), the classifier's (2 heads, d=64), and small
    # causal / ragged / cross / fully-masked-row cases in float32 (the
    # CUDA-core kernels) and in bf16 (the tensor-core kernels), and a bf16
    # view that starts 8 bytes into its rows, which 16-byte copies cannot
    # read: it must take the CUDA-core kernels; head dims 320 and 512; more
    # than 65,535 (batch, head) pairs. The float32 cases name the variant of
    # csrc/flash_bwd.cu they must take: "tiled" for the float32 U-Net's three
    # shapes at 64x64, contiguous and as slices of its fused qkv, head dims
    # 32, 100 and 192 (padded), the small cases (causal with s_q < s_k,
    # ragged, rows that see no key) and more than 65,535 pairs; "general" for
    # a float32 view 4 bytes into its rows, for bf16 and above head dim 256.
    # Every lse comes from K3 by the route of the same inputs, so the pair
    # forward + backward is held. (q, s_k, causal, dtype, route, variant of
    # the CUDA-core route or None, layout of flash_inputs)
    cases = ([((2, 1, 16384, 64), 16384, False, bf16, "sm90", None, ""),
              ((2, 1, 4096, 128), 4096, False, bf16, "sm90", None, ""),
              ((2, 1, 1024, 256), 1024, False, bf16, "sm90", None, ""),
              ((2, 1, 1024, 192), 1024, False, bf16, "sm90", None, ""),
              ((2, 2, 1024, 64), 1024, False, bf16, "sm90", None, ""),
              ((1, 1, 512, 64), 512, False, f32, cc, "tiled", "")]
             + [((2, 1, s, d), s, False, f32, cc, "tiled", layout)
                for s, d in ((4096, 64), (1024, 128), (256, 256)) for layout in ("", "qkv")]
             + [((2, 2, 300, 32), 300, True, f32, cc, "tiled", ""),
                ((2, 2, 200, 100), 200, True, f32, cc, "tiled", ""),
                ((2, 2, 300, 192), 300, False, f32, cc, "tiled", "")]
             + [c + (f32, cc, "tiled", "") for c in small]
             + [c + (bf16, "sm90", None, "") for c in small]
             + [((2, 2, 300, 64), 300, True, bf16, cc, "general", "unaligned"),
                ((2, 2, 300, 64), 300, True, f32, cc, "general", "off4")]
             + [c + ("general", "") for c in wide_heads]
             + [c + ("tiled" if c[3] == f32 else None, "") for c in many_heads])
    errs["flash_bwd_dkv"] = errs["flash_bwd_dq"] = 0.0
    for (q_shape, s_k, causal, dtype, route, variant, layout) in cases:
        q, k, v, do = flash_inputs(q_shape, s_k, dtype, layout, SEED + 20)
        o, lse = att.flash_attention(q, k, v, causal, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        # the wrappers count each launch made from Python outside a capture; a
        # replayed CUDA graph (a training step's) launches without them, and the
        # training phases count its launches by name in a device trace
        # (_traced_launches, held to _with_replays)
        before = dict(att.flash_bwd_dkv.route_counts), dict(att.flash_bwd_dq.route_counts)
        before_v = _flash_variants()
        dk, dv = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk2, dv2 = att.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq2 = att.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        for fn, was in zip((att.flash_bwd_dkv, att.flash_bwd_dq), before):
            took = {r: n - was[r] for r, n in fn.route_counts.items() if n != was[r]}
            took_v = {v_: n - before_v[fn.__name__][v_] for v_, n in fn.variant_counts.items()
                      if n != before_v[fn.__name__][v_]}
            if took != {route: 2} or took_v != ({} if variant is None else {variant: 2}):
                raise AssertionError(f"K4/K5 q{q_shape} {dtype} {layout}: routes {took}, "
                                     f"variants {took_v}, want {route} {variant}")
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"K4/K5 q{q_shape} {dtype}: two launches gave different bits")
        want = att.flash_backward_reference(q, k, v, do, lse, delta, causal)
        # the plain version rounding P and dS where the tensor-core kernels do
        want_p = (att.flash_backward_reference(q, k, v, do, lse, delta, causal,
                                               p_dtype=torch.bfloat16)
                  if route == "sm90" else want)
        tol = TOL_BWD_BF16 if dtype == torch.bfloat16 else TOL_BWD_F32
        rel, rel_p = [], []
        for got, ref, ref_p, name in zip((dq, dk, dv), want, want_p, ("dq", "dk", "dv")):
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"K4/K5 {name}: {got.shape} {got.dtype}, want "
                                     f"{ref.shape} {ref.dtype}")
            diff = (got.float() - ref.float()).abs().max().item()
            rel.append(diff / ref.float().abs().max().item())
            rel_p.append((got.float() - ref_p.float()).abs().max().item()
                         / ref.float().abs().max().item())
            errs["flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"] = max(
                errs["flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"], diff)
        log("kernels", f"K4/K5 flash backward q{q_shape} s_k={s_k} causal={causal} {dtype}"
            + {"unaligned": " (view 8 bytes into its rows)", "off4": " (view 4 bytes into its "
               "rows)", "qkv": " (slices of one qkv)"}.get(layout, "")
            + f", route {route}{'' if variant is None else ', variant ' + variant}: "
            f"max|d|/max|ref| dq {rel[0]:.3g} dk {rel[1]:.3g} dv {rel[2]:.3g} (tol {tol})"
            + (f"; against the plain version with bf16 P and dS dq {rel_p[0]:.3g} dk "
               f"{rel_p[1]:.3g} dv {rel_p[2]:.3g}" if route == "sm90" else "")
            + "; two launches equal bits")
        if not max(rel) <= tol:
            raise AssertionError(f"K4/K5 q{q_shape} s_k={s_k}: {rel} > {tol}")
        del q, k, v, do, o, lse, delta, dq, dk, dv, dq2, dk2, dv2, want, want_p

    # under autograd, on column slices of one qkv as the U-Net calls it, and
    # rows that see no key (causal, s_q > s_k) against attention_reference
    qkv = _uniform((2, 4096, 3 * 128), -2, 2, SEED + 30, torch.bfloat16).requires_grad_()
    cot = _uniform((2, 4096, 128), -1, 1, SEED + 31, torch.bfloat16)
    (att.mha(*qkv.chunk(3, dim=-1), 1).float() * cot.float()).sum().backward()
    q, k, v = (t.detach().reshape(2, 4096, 1, 128).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    o, lse = att.flash_reference(q, k, v)
    do = cot.reshape(2, 4096, 1, 128).transpose(1, 2)
    want = att.flash_backward_reference(q, k, v, do, lse, (do.float() * o.float()).sum(-1))
    want = torch.cat([g.transpose(1, 2).reshape(2, 4096, 128) for g in want], dim=-1)
    rel = ((qkv.grad.float() - want.float()).abs().max() / want.float().abs().max()).item()
    log("kernels", f"K3+K4+K5 under autograd on qkv slices (2,4096,3x128) bf16: "
        f"max|d|/max|ref| {rel:.3g} (tol {TOL_BWD_BF16})")
    if not rel <= TOL_BWD_BF16:
        raise AssertionError(f"flash autograd on qkv slices: {rel} > {TOL_BWD_BF16}")
    q = _uniform((1, 2, 200, 32), -2, 2, SEED + 32).requires_grad_()
    k, v = (_uniform((1, 2, 150, 32), -2, 2, SEED + 33 + i).requires_grad_() for i in range(2))
    cot = _uniform((1, 2, 200, 32), -1, 1, SEED + 35)
    (att.flash_attention(q, k, v, causal=True) * cot).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (att.attention_reference(*ref, causal=True) * cot).sum().backward()
    err = max((t.grad - r.grad).abs().max().item() for t, r in zip((q, k, v), ref))
    log("kernels", f"K4/K5 causal q 200 kv 150 (50 rows see no key) f32: gradients vs "
        f"autograd through attention_reference max|d| {err:.3g} (tol {TOL_BWD_F32})")
    for t, r in zip((q, k, v), ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=TOL_BWD_F32, atol=TOL_BWD_F32)
    # the same in bf16 (the tensor-core kernels) against autograd through
    # attention_reference on the float32 values of the same bf16 inputs
    lo = [t.detach().to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    # eager autograd: one count a launch (graphed training steps: _traced_launches)
    was = att.flash_bwd_dkv.route_counts["sm90"], att.flash_bwd_dq.route_counts["sm90"]
    (att.flash_attention(*lo, causal=True).float() * cot).sum().backward()
    if (att.flash_bwd_dkv.route_counts["sm90"], att.flash_bwd_dq.route_counts["sm90"]) != (
            was[0] + 1, was[1] + 1):
        raise AssertionError("the bf16 backward did not take the tensor-core kernels")
    ref = [t.detach().float().requires_grad_() for t in lo]
    (att.attention_reference(*ref, causal=True) * cot).sum().backward()
    rel = max(((t.grad.float() - r.grad).abs().max() / r.grad.abs().max()).item()
              for t, r in zip(lo, ref))
    log("kernels", f"K4/K5 causal q 200 kv 150 (50 rows see no key) bf16, route sm90: gradients "
        f"vs autograd through attention_reference in float32 max|d|/max|ref| {rel:.3g} "
        f"(tol {TOL_BWD_BF16})")
    if not rel <= TOL_BWD_BF16:
        raise AssertionError(f"bf16 blind rows: {rel} > {TOL_BWD_BF16}")
    errs.update(check_matmul())
    return errs


def _int8(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to("cuda")


# K6's shapes (M, K, N). As int8 serving calls it (K padded to 16 by im2col,
# B a strided view of the (N, K) weight): the generator's 7x7 stem, mel stem,
# last 3x3, 1x1 bottleneck, last 1x1 and largest conv, M cut to 65,536 rows
# where it was 1,179,648 or 163,840; the ViViT's qkv, MLP-in and MLP-out.
K6_SERVING_SHAPES = [(65536, 304, 16), (65536, 16, 32), (65536, 720, 32), (128, 4608, 512),
                     (65536, 32, 3), (65536, 1440, 64),
                     (30720, 256, 768), (30720, 256, 1024), (30720, 1024, 256)]
# Row-major B, depths that are no multiple of 16 (route "packed": the pack's
# transposing or gathering path for B, its shifting path for A): the stems
# before padding and ragged shapes.
K6_ROW_MAJOR_SHAPES = [(65536, 294, 16), (65536, 9, 32), (257, 131, 67), (5, 9, 3)]
# The tensor-core kernel's edges, B the (N, K) weight transposed: M, N and K
# one above and one below a tile, a single element of C, and more columns
# than one grid axis of 64-column blocks holds (65,535 x 64).
K6_EDGE_SHAPES = [(129, 144, 72), (255, 4608, 8), (1, 16, 1), (2, 16, 65535 * 64 + 8)]


def check_matmul() -> dict:
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    errs = {"int8_matmul": 0.0, "bf16_matmul": 0.0}
    # (shape, layout of B, route of int8, route of bf16)
    cases = ([(shape, "transposed", "sm90", "sm90") for shape in K6_SERVING_SHAPES]
             + [(shape, "row_major", "packed", "packed") for shape in K6_ROW_MAJOR_SHAPES]
             # the microbench's operands: a row-major bf16 B is the tensor-core
             # kernel's MN-major operand, a row-major int8 B is packed first
             + [((4096, 4096, 4096), "row_major", "packed", "sm90"),
                ((4096, 4096, 4096), "transposed", "sm90", "sm90")]
             + [(shape, "transposed", "sm90", "sm90") for shape in K6_EDGE_SHAPES]
             # views that start one element into wider rows: no tensor map reads them
             + [((300, 64, 48), "unaligned", "packed", "packed")])
    for (m, k, n), layout, route8, route16 in cases:
        pad = 16 if layout == "unaligned" else 0

        def operands(make_a, make_b):
            a = make_a((m, k + pad))[:, 1:1 + k] if pad else make_a((m, k))
            if layout == "row_major":
                return a, make_b((k, n))
            b = make_b((n, k + pad))
            return a, (b[:, 1:1 + k] if pad else b).t()

        a8, b8 = operands(lambda sh: _int8(sh, SEED + 60), lambda sh: _int8(sh, SEED + 61))
        a16, b16 = operands(lambda sh: _uniform(sh, -1, 1, SEED + 62, torch.bfloat16),
                            lambda sh: _uniform(sh, -1, 1, SEED + 63, torch.bfloat16))
        before = dict(mm.int8_matmul.route_counts), dict(mm.bf16_matmul.route_counts)
        packs = mm.int8_matmul.pack_launch_count, mm.bf16_matmul.pack_launch_count
        got, again = mm.int8_matmul(a8, b8), mm.int8_matmul(a8, b8)
        got16, again16 = mm.bf16_matmul(a16, b16), mm.bf16_matmul(a16, b16)
        torch.cuda.synchronize()
        for fn, was, route, (a, b), packed in zip((mm.int8_matmul, mm.bf16_matmul), before,
                                                   (route8, route16), ((a8, b8), (a16, b16)),
                                                   packs):
            took = {r: c - was[r] for r, c in fn.route_counts.items() if c != was[r]}
            # two launches, each packing the operands no tensor map reads
            want_packs = 2 * sum(mm._packs(a.dtype, m, n, k, a.stride(), b.stride(),
                                           a.data_ptr(), b.data_ptr()))
            if took != {route: 2} or fn.pack_launch_count - packed != want_packs:
                raise AssertionError(f"K6 {fn.__name__} ({m},{k},{n}) B {layout}: routes {took}, "
                                     f"{fn.pack_launch_count - packed} packs; want {route}, "
                                     f"{want_packs}")
        if not (torch.equal(got, again) and torch.equal(got16, again16)):
            raise AssertionError(f"K6 ({m},{k},{n}) B {layout}: two launches gave different bits")
        want = mm.matmul_reference(a8, b8)
        err8 = (got - want).abs().max().item()
        want16 = mm.matmul_reference(a16, b16)
        err16 = (got16 - want16).abs().max().item()
        bound16 = TOL_K6_BF16 * want16.abs().max().item()
        log("kernels", f"K6 matmul ({m} x {k} x {n}) B {layout}, routes int8 {route8} / bf16 "
            f"{route16}: int8 max|d| {err8} (must be 0), bf16 max|d| {err16:.3g} (tol "
            f"{bound16:.3g} = {TOL_K6_BF16} of max|C|); two launches equal bits")
        if got.dtype != torch.int32 or got16.dtype != torch.float32:
            raise AssertionError(f"K6 output types {got.dtype}, {got16.dtype}")
        if err8 != 0 or not err16 <= bound16:
            raise AssertionError(f"K6 ({m},{k},{n}): int8 max|d| {err8}, bf16 {err16} > {bound16}")
        errs["int8_matmul"] = max(errs["int8_matmul"], float(err8))
        errs["bf16_matmul"] = max(errs["bf16_matmul"], err16)
        del a8, b8, got, again, want, a16, b16, got16, again16, want16
    errs["matmul_pack"] = check_pack()
    return errs


def check_pack() -> float:
    """K6's pack (``csrc/int8_mm.cu``) bit for bit against ``pack_reference``
    in int8 and bf16, each case by the path it must take: the row-major
    shapes' A (odd K: shifted rows) and B read as (N, K) (transposed where
    its depths start on 16-byte boundaries, else gathered), the unaligned
    view's A and B, a broadcast A (row stride 0) and the 4096² transposition.
    Returns the largest difference (0)."""
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    for dtype in (torch.int8, torch.bfloat16):
        size = 1 if dtype == torch.int8 else 2

        def draw(shape, seed):
            return (_int8(shape, seed) if dtype == torch.int8
                    else _uniform(shape, -1, 1, seed, torch.bfloat16))

        cases = []
        for m, k, n in K6_ROW_MAJOR_SHAPES:
            cases += [(f"A ({m},{k})", draw((m, k), SEED + 64), "rows"),
                      (f"B ({k},{n}) row-major as (N,K)", draw((k, n), SEED + 65).t(),
                       "transpose" if (n * size) % 16 == 0 else "gather")]
        m, k, n = 300, 64, 48
        cases += [("A (300,64) one element in", draw((m, k + 16), SEED + 66)[:, 1:1 + k], "rows"),
                  ("B (48,64) one element in", draw((n, k + 16), SEED + 67)[:, 1:1 + k], "rows"),
                  ("A (64,32) broadcast rows", draw((1, 32), SEED + 68).expand(64, 32), "rows"),
                  ("B (4096,4096) row-major as (N,K)", draw((4096, 4096), SEED + 69).t(),
                   "transpose")]
        for name, x, path in cases:
            got_path = mm.pack_path(dtype, x.stride(), x.data_ptr())
            before = mm.pack_k_major.launch_count, mm.pack_k_major.path_counts[path]
            got, want = mm.pack_k_major(x), mm.pack_reference(x)
            torch.cuda.synchronize()
            counted = (mm.pack_k_major.launch_count - before[0],
                       mm.pack_k_major.path_counts[path] - before[1])
            bits = (lambda t: t) if dtype == torch.int8 else (lambda t: t.view(torch.int16))
            if got_path != path or counted != (1, 1) or not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"K6 pack {dtype} {name}: path {got_path} (want {path}), "
                                     f"launches {counted}, equal bits "
                                     f"{torch.equal(bits(got), bits(want))}")
            log("kernels", f"K6 pack {str(dtype).split('.')[-1]} {name} {tuple(x.shape)} strides "
                f"{x.stride()}: path {path}, equal bits to pack_reference, rows "
                f"{got.stride(0)} elements apart")
            del x, got, want
    return 0.0


def flax_vivit_params(cfg, seed: int) -> dict:
    """Random weights in the Flax ViViT's tree and shapes (the card's
    machine has no flax): Dense kernels ~ N(0, 1/fan_in), small biases,
    LayerNorm scales near 1."""
    rng = np.random.default_rng(seed)
    e = cfg.hidden_size

    def dense(n_in, n_out):
        return {"kernel": rng.standard_normal((n_in, n_out)).astype(np.float32)
                / math.sqrt(n_in),
                "bias": 0.02 * rng.standard_normal(n_out).astype(np.float32)}

    def norm(n):
        return {"scale": 1 + 0.05 * rng.standard_normal(n).astype(np.float32),
                "bias": 0.05 * rng.standard_normal(n).astype(np.float32)}

    tt, th, tw = cfg.tubelet_size
    n_tokens = (cfg.num_frames // tt) * (cfg.image_size // th) * (cfg.image_size // tw)
    params = {"TubeletEmbed_0": {"proj": dense(tt * th * tw * cfg.num_channels, e)},
              "pos_embedding": 0.02 * rng.standard_normal((1, n_tokens, e)).astype(np.float32)}
    for i in range(cfg.num_layers):
        params[f"block_{i}"] = {
            "LayerNorm_0": norm(e), "qkv": dense(e, 3 * e), "proj": dense(e, e),
            "LayerNorm_1": norm(e),
            "MLP_0": {"Dense_0": dense(e, cfg.mlp_dim), "Dense_1": dense(cfg.mlp_dim, e)}}
    params["LayerNorm_0"] = norm(e)
    params["head"] = dense(e, cfg.num_classes)
    return params


def request_inputs(n_clips: int, seed: int):
    """bench.py's inputs: random 96×96 RGB uint8 frames, face boxes
    [8, 92, 6, 90] ± 2."""
    rng = np.random.default_rng(seed)
    n = n_clips * CLIP_FRAMES
    frames = rng.integers(0, 256, (n, 96, 96, 3), dtype=np.uint8)
    boxes = (np.tile([8.0, 92.0, 6.0, 90.0], (n, 1))
             + rng.uniform(-2, 2, (n, 4))).astype(np.float32)
    return frames, boxes


def serve(model, frames: np.ndarray, boxes: np.ndarray) -> torch.Tensor:
    """One request through the main path, ``predict_frames`` on the model's
    device: host frames and boxes in, host log-probs out."""
    from lipreading_video_generation_tpu_torch.pipelines.train_vivit import predict_frames

    return torch.from_numpy(predict_frames(model, frames, boxes))


def serve_roi(frames: np.ndarray, boxes: np.ndarray, device) -> torch.Tensor:
    """The (B·T, 32, 32, 1) uint8 ROI a request's ``predict_frames`` makes
    on ``device``, on the host."""
    from lipreading_video_generation_tpu_torch.core.config import PreprocessConfig
    from lipreading_video_generation_tpu_torch.pipelines.preprocess import mouth_roi_pipeline

    pre = PreprocessConfig()
    return mouth_roi_pipeline(torch.from_numpy(frames).to(device),
                              torch.from_numpy(boxes).to(device), pre.lip_crop_size,
                              pre.model_input_size, pre.clahe_clip_limit, pre.clahe_grid).cpu()


def serve_int8_request(model, frames: np.ndarray, boxes: np.ndarray) -> dict:
    """One request through ``predict_step_int8`` (host frames in, host
    log-probs out) and the same through ``predict_frames``; returns the int8
    request's launches."""
    from lipreading_video_generation_tpu_torch.core.config import PreprocessConfig
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as tv
    from lipreading_video_generation_tpu_torch.pipelines.preprocess import mouth_roi_pipeline

    cfg, pre = model.cfg, PreprocessConfig()

    def request(step):
        roi = mouth_roi_pipeline(torch.from_numpy(frames).to("cuda"),
                                 torch.from_numpy(boxes).to("cuda"), pre.lip_crop_size,
                                 pre.model_input_size, pre.clahe_clip_limit, pre.clahe_grid)
        clips = roi.reshape(-1, cfg.num_frames, cfg.image_size, cfg.image_size, 1)
        return step(model, clips).cpu()

    n_linear = sum(isinstance(m, torch.nn.Linear) for m in model.modules())
    request(tv.predict_step_int8)                                  # warm-up
    before = (cl.clahe_cuda.launch_count, att.small_mha.launch_count,
              mm.int8_matmul.launch_count)
    routed = att.small_mha.route_counts["sm90"], mm.int8_matmul.route_counts["sm90"]
    t0 = time.perf_counter()
    q = request(tv.predict_step_int8)
    q_s = time.perf_counter() - t0
    d = (cl.clahe_cuda.launch_count - before[0], att.small_mha.launch_count - before[1],
         mm.int8_matmul.launch_count - before[2])
    if d != (1, cfg.num_layers, n_linear):
        raise AssertionError(f"int8 request launched K1/K2/K6 {d}, want "
                             f"(1, {cfg.num_layers}, {n_linear})")
    by_tc = (att.small_mha.route_counts["sm90"] - routed[0],
             mm.int8_matmul.route_counts["sm90"] - routed[1])
    if by_tc != (cfg.num_layers, n_linear):
        raise AssertionError(f"int8 request: K2/K6 launches by the tensor-core route {by_tc}, "
                             f"want ({cfg.num_layers}, {n_linear})")
    t0 = time.perf_counter()
    f = serve(model, frames, boxes)
    f_s = time.perf_counter() - t0
    if mm.int8_matmul.launch_count - before[2] != n_linear:
        raise AssertionError("predict_frames launched K6")
    agree = (q.argmax(-1) == f.argmax(-1)).float().mean().item()
    worst = (q - f).abs().max().item()
    log("serve", f"predict_step_int8, batch {len(q)}: K1 1, K2 {cfg.num_layers}, K6 {n_linear} "
        f"launches, K2 and K6 all by the tensor-core route; against predict_frames on the same frames: top-1 agreement {agree:.4f} "
        f"(want >= {INT8_TOP1_AGREE}), max |d log-prob| {worst:.4f} (want < {INT8_LOGPROB}); "
        f"request {q_s * 1e3:.3f} ms int8, {f_s * 1e3:.3f} ms bf16")
    if not (torch.isfinite(q).all() and agree >= INT8_TOP1_AGREE and worst < INT8_LOGPROB):
        raise AssertionError(f"int8 ViViT: agreement {agree}, max |d log-prob| {worst}")
    _profile_step("serve", lambda: request(tv.predict_step_int8), "int8 request")
    return {"clahe": d[0], "small_mha": d[1], "int8_matmul": d[2]}


K1_PROFILED_MS = []   # K1's device time in the profiled batch-384 ViViT request

# [flops]: each path's FLOPs counted once on the card (utils/flops.flops_detail,
# eagerly, untimed) by the phase that times it, on its own objects right after
# its timed runs: path -> {"detail", "median_s", "what"}; reported by
# phase_flops against the median those runs measured
FLOPS_PATHS: dict = {}
# the hand-written kernels' wrappers, by the names a count records them under
FLOPS_KERNELS = {"clahe_cuda": "K1", "small_mha": "K2", "flash_attention": "K3",
                 "flash_fwd_combine": "K3 combine", "flash_bwd_dkv": "K4", "flash_bwd_dq": "K5",
                 "int8_matmul": "K6", "bf16_matmul": "K6 bf16", "pack_k_major": "K6 pack"}


def _kernel_wrappers() -> tuple:
    """The functions that launch the hand-written kernels and count them."""
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    return (cl.clahe_cuda, att.small_mha, att.flash_attention, att.flash_fwd_combine,
            att.flash_bwd_dkv, att.flash_bwd_dq, mm.int8_matmul, mm.bf16_matmul, mm.pack_k_major)


def _wrapper_launches() -> dict:
    """Each hand-written kernel's ``launch_count`` so far."""
    return {w.__name__: w.launch_count for w in _kernel_wrappers()}


def count_flops(path: str, what: str, median_s: float, want: dict, fn, *args) -> dict:
    """``flops_detail`` of one call ``fn(*args)`` on the card, kept in
    ``FLOPS_PATHS[path]`` beside the path's median time; fails unless every
    launch of a hand-written kernel in that call (the deltas of the
    wrappers' ``launch_count``) is in the count's records, and the launches
    are ``want``."""
    from lipreading_video_generation_tpu_torch.utils import flops

    before = _wrapper_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    detail = flops.flops_detail(fn, *args)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in _wrapper_launches().items() if n != before[k]}
    recorded = {k: v["launches"] for k, v in detail["kernels"].items()}
    log("flops", f"{path}: {what}: counted on the card in {took:.2f} s (not timed); "
        f"model {detail['model']} hw {detail['hw']} FLOP; launches {launched}, in the count "
        f"{recorded}")
    if launched != recorded or launched != want:
        raise AssertionError(f"{path}: kernel launches {launched}, the count's records "
                             f"{recorded}, want {want}")
    FLOPS_PATHS[path] = {"detail": detail, "median_s": median_s, "what": what}
    return detail


def phase_serve(dev: dict) -> dict:
    from lipreading_video_generation_tpu_torch.core.config import ViViTConfig
    from lipreading_video_generation_tpu_torch.models.convert import vivit_state_dict_from_flax
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl

    cfg = ViViTConfig(num_classes=64)
    state = vivit_state_dict_from_flax(flax_vivit_params(cfg, SEED))
    model = ViViT(cfg).eval()
    model.load_state_dict(state)
    cpu_model = ViViT(cfg).eval()
    cpu_model.load_state_dict(state)
    model = model.to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    log("serve", f"ViViT defaults: layers={cfg.num_layers} hidden={cfg.hidden_size} "
        f"heads={cfg.num_heads} mlp={cfg.mlp_dim} dtype={cfg.dtype} "
        f"classes={cfg.num_classes}; {n_params} params from seeded numpy via "
        "vivit_state_dict_from_flax")

    inputs = {8: request_inputs(8, SEED), 384: request_inputs(384, SEED)}
    times = {8: [], 384: []}
    with torch.inference_mode():
        for n_clips in inputs:                           # warm-up: cuBLAS, allocator
            serve(model, *inputs[n_clips])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        for n_clips in (8, 8, 8, 384, 384, 384):
            k1, k2 = cl.clahe_cuda.launch_count, att.small_mha.launch_count
            t0 = time.perf_counter()
            logp = serve(model, *inputs[n_clips])
            times[n_clips].append(time.perf_counter() - t0)
            d1, d2 = cl.clahe_cuda.launch_count - k1, att.small_mha.launch_count - k2
            if (d1, d2) != (1, cfg.num_layers):
                raise AssertionError(f"request of {n_clips} clips launched K1 {d1}x and "
                                     f"K2 {d2}x, want 1 and {cfg.num_layers}")
            if logp.shape != (n_clips, cfg.num_classes) or not torch.isfinite(logp).all():
                raise AssertionError(f"bad log-probs {tuple(logp.shape)} for {n_clips} clips")
        launches = {"clahe": cl.clahe_cuda.launch_count,
                    "small_mha": att.small_mha.launch_count}
        if cl.clahe_cuda.route_counts != {"packed": launches["clahe"], "tiled": 0}:
            raise AssertionError(f"serve: K1 took the routes {cl.clahe_cuda.route_counts}, "
                                 "want all packed")
        peak = torch.cuda.max_memory_allocated()
        _all_by_tensor_cores("serve", att.small_mha)
        log("serve", f"6 requests: launches K1={launches['clahe']} K2={launches['small_mha']} "
            f"(1 and {cfg.num_layers} per request; K1 routes {cl.clahe_cuda.route_counts}, K2 "
            f"routes {att.small_mha.route_counts}); "
            "log-probs finite")
        # where the time of a batch-384 request goes
        busy_ms = _profile_step("serve", lambda: serve(model, *inputs[384]), "request")
        k1_ms, k1_n = _profile_step.own["K1"]
        if k1_n != 1:
            raise AssertionError(f"the profiled request ran {k1_n} K1 kernels, want 1")
        log("serve", f"K1 in the profiled batch-384 request: {k1_ms:.4f} ms of device time, one "
            "launch by the packed route (the one-block-an-image kernel it replaced: 0.094 ms) on "
            f"{dev['smi']}")
        K1_PROFILED_MS.append(k1_ms)

        gpu_logp, gpu_roi = serve(model, *inputs[8]), serve_roi(*inputs[8], "cuda")
        cpu_logp, cpu_roi = serve(cpu_model, *inputs[8]), serve_roi(*inputs[8], "cpu")

        # [flops]: the batch-384 request, and batch 8 on the card against the CPU
        from lipreading_video_generation_tpu_torch.utils import flops

        want = {"clahe_cuda": 1, "small_mha": cfg.num_layers}
        count_flops("serve", "a batch-384 bf16 ViViT request", statistics.median(times[384]),
                    want, serve, model, *inputs[384])
        card8 = count_flops("serve_b8", "a batch-8 bf16 ViViT request",
                            statistics.median(times[8]), want, serve, model, *inputs[8])
        cpu8 = flops.flops_detail(serve, cpu_model, *inputs[8])
        log("flops", f"serve_b8: model FLOP on the card {card8['model']} (K2 "
            f"{card8['kernels']['small_mha']['model']} by its hook), on the CPU {cpu8['model']} "
            f"(K2's products by the einsum path); hw {card8['hw']} and {cpu8['hw']}")
        if card8["model"] != cpu8["model"]:
            raise AssertionError(f"ViViT batch 8: model FLOPs {card8['model']} on the card, "
                                 f"{cpu8['model']} on the CPU")
    d = (gpu_roi.int() - cpu_roi.int()).abs()
    within1 = (d <= 1).float().mean().item()
    # a log-prob is its logit less the clip's log-sum-exp: centred over the
    # classes, both sides are their logits centred, which TOL_LOGITS bounds
    gpu_c = gpu_logp - gpu_logp.mean(-1, keepdim=True)
    cpu_c = cpu_logp - cpu_logp.mean(-1, keepdim=True)
    gap = (gpu_logp - cpu_logp).abs() / cpu_logp.std(dim=-1, keepdim=True)
    log("serve", f"batch 8, card vs CPU plain path: ROI max|d| {d.max().item()} levels, "
        f"{within1:.5f} within 1 (want >= 0.99); centred log-probs max|d| "
        f"{(gpu_c - cpu_c).abs().max().item():.4g} of max|centred log-prob| "
        f"{cpu_c.abs().max().item():.4g} (tol {TOL_LOGITS} abs + rel); log-prob gap over the "
        f"clip's spread max {gap.max().item():.4g}, mean {gap.mean().item():.4g}")
    if within1 < 0.99:
        raise AssertionError(f"ROI card vs CPU: only {within1} within 1 level")
    torch.testing.assert_close(gpu_c, cpu_c, rtol=TOL_LOGITS, atol=TOL_LOGITS)

    for name, count in serve_int8_request(model, *inputs[384]).items():
        launches[name] = launches.get(name, 0) + count

    per_req = statistics.median(times[384])
    log("serve", f"request times ({dev['smi']}): batch 8 "
        f"{[round(t * 1e3, 3) for t in times[8]]} ms; batch 384 "
        f"{[round(t * 1e3, 3) for t in times[384]]} ms; batch 384 median "
        f"{per_req * 1e3:.3f} ms = {384 * CLIP_FRAMES / per_req:.1f} frames/s (the profiled "
        f"request's {busy_ms:.3f} ms of kernels and copies are {busy_ms / (per_req * 1e3):.3f} "
        f"of it); peak device memory {peak / 2**20:.1f} MiB")
    return launches


# ViViT training (phase [vivit-train]): the card's train step against the
# CPU's on the same batch of 16 and bridged weights. float32 (K2 by its
# CUDA-core route, cuBLAS without TF32) against the CPU: summation order
# only, through 12 blocks and their backward; bf16 (K2 by the tensor-core
# route): bf16 rounds at other points on each side.
TOL_VT = {"float32": 1e-4, "bfloat16": 2e-2}
VT_BATCH = 16
VT_SERVE_BATCH = 384
VT_CLI_STEPS = 128          # 4 epochs of the CLI's 512 clips at batch 16


def _vt_batch(n: int, seed: int) -> dict:
    """A ``WordClipSampler`` batch of ``n`` synthetic word clips (8 classes)."""
    from lipreading_video_generation_tpu_torch.data.datasets import (
        WordClipSampler, synthetic_word_clips)

    clips, labels = synthetic_word_clips(n=n, num_classes=8, seed=seed)
    return next(WordClipSampler(clips, labels, seed=seed).batches(n))


def _k_bias(name: str, t: torch.Tensor) -> torch.Tensor:
    """False at the key third of each qkv bias, whose gradient is exactly 0
    (a shift of a query row's scores leaves its softmax as it was): what
    either side computes there is cancellation noise."""
    keep = torch.ones(t.shape, dtype=torch.bool)
    if name.endswith("qkv.bias"):
        e = t.shape[0] // 3
        keep[e:2 * e] = False
    return keep


def vivit_step_capture(cfg, state_dict, batch, device) -> dict:
    """One ``train_step`` of a fresh state on ``device`` loaded with
    ``state_dict``: loss, logits, every gradient, every updated parameter,
    and block 0's qkv output with the gradient that reached its attention
    output (K2's inputs and cotangent), all on the host."""
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as tv

    state = tv.create_state(cfg, seed=SEED, device=device)
    state.model.load_state_dict(state_dict)
    seen = {}
    hooks = [state.model.register_forward_hook(lambda m, i, o: seen.update(logits=o.detach())),
             state.model.blocks[0].qkv.register_forward_hook(
                 lambda m, i, o: seen.update(qkv=o.detach().clone())),
             state.model.blocks[0].proj.register_full_backward_hook(
                 lambda m, gi, go: seen.update(g_attn=gi[0].detach().clone()))]
    try:
        metrics = tv.train_step(state, batch)
    finally:
        for h in hooks:
            h.remove()
    return {"loss": metrics["loss"].item(), "logits": seen["logits"].float().cpu(),
            "grads": {n: p.grad.detach().float().cpu()
                      for n, p in state.model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in state.model.named_parameters()},
            "qkv": seen["qkv"], "g_attn": seen["g_attn"], "lr": cfg.learning_rate}


def compare_vivit_steps(got: dict, want: dict, tol: float) -> dict:
    """Largest errors of a step against a reference step: loss (relative),
    logits and each gradient (of the largest |value| of its tensor, the
    key biases' exact zeros aside), the whole gradient (relative L2), and
    the updated params: their largest |d|, the share of entries off by more
    than 1e-6, and how many of those have a gradient above ``tol`` of its
    tensor's largest. Adam's first step moves a weight by lr·g/(|g| + eps),
    about lr·sign(g), so only a gradient within the gradients' error of 0
    may step the other way (by at most 2·lr)."""
    loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    logits = ((got["logits"] - want["logits"]).abs().max()
              / want["logits"].abs().max()).item()
    grad, worst, num, den, off, unexplained, n_all = 0.0, "", 0.0, 0.0, 0, 0, 0
    for n, w in want["grads"].items():
        keep = _k_bias(n, w)
        d = (got["grads"][n] - w)[keep].abs().max().item() / w[keep].abs().max().item()
        if d > grad:
            grad, worst = d, n
        num += float(((got["grads"][n] - w).double()[keep] ** 2).sum())
        den += float((w.double()[keep] ** 2).sum())
        moved = (got["params"][n] - want["params"][n]).abs() > 1e-6
        off += int(moved.sum())
        n_all += moved.numel()
        unexplained += int((moved & (w.abs() > tol * w.abs().max())).sum())
    diffs = torch.cat([(got["params"][n] - w).abs().flatten() for n, w in want["params"].items()])
    return {"loss": loss, "logits": logits, "grad": grad, "grad_worst": worst,
            "grad_l2": math.sqrt(num / den), "param": diffs.max().item(),
            "param_share": off / n_all, "param_unexplained": unexplained}


def phase_vivit_train(dev: dict) -> dict:
    import ast
    import contextlib
    import dataclasses
    import io

    from lipreading_video_generation_tpu_torch import cli
    from lipreading_video_generation_tpu_torch.core.config import ViViTConfig
    from lipreading_video_generation_tpu_torch.core.metrics import RunningMean
    from lipreading_video_generation_tpu_torch.models.convert import vivit_state_dict_from_flax
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as tv

    phase_t0 = time.perf_counter()
    base = ViViTConfig(num_classes=8)
    sd = vivit_state_dict_from_flax(flax_vivit_params(base, SEED))
    batch = _vt_batch(VT_BATCH, SEED + 40)
    log("vivit-train", f"ViViTConfig defaults (layers={base.num_layers} hidden={base.hidden_size} "
        f"heads={base.num_heads} mlp={base.mlp_dim} dropout={base.dropout}), 8 classes, "
        f"AdamW lr {base.learning_rate} wd {base.weight_decay} (0.9, 0.999, 1e-8), batch "
        f"{VT_BATCH} of synthetic_word_clips; weights from seeded numpy via "
        "vivit_state_dict_from_flax")

    # 1. one step, card against CPU, in both types
    for dtype, route in (("float32", "cuda_core"), ("bfloat16", "sm90")):
        cfg = dataclasses.replace(base, dtype=dtype)
        before = dict(att.small_mha.route_counts)
        gpu = vivit_step_capture(cfg, sd, batch, "cuda")
        took = {r: n - before[r] for r, n in att.small_mha.route_counts.items()}
        want_routes = {r: (cfg.num_layers if r == route else 0) for r in took}
        if took != want_routes:
            raise AssertionError(f"vivit-train {dtype} step: K2 routes {took}, want {want_routes}")
        cpu = vivit_step_capture(cfg, sd, batch, "cpu")
        e = compare_vivit_steps(gpu, cpu, TOL_VT[dtype])
        tol = TOL_VT[dtype]
        log("vivit-train", f"{dtype} step, card (K2 {cfg.num_layers}x by {route}) vs CPU plain "
            f"path: loss {gpu['loss']:.7g} vs {cpu['loss']:.7g} (rel {e['loss']:.3g}); logits "
            f"{e['logits']:.3g} of max|ref|; gradients {e['grad']:.3g} of their tensor's "
            f"max|ref| (worst {e['grad_worst']}), whole gradient rel L2 {e['grad_l2']:.3g}; "
            f"updated params max|d| {e['param']:.3g} (2·lr = {2 * cfg.learning_rate:g}), "
            f"{e['param_share']:.5f} of them off by > 1e-6, {e['param_unexplained']} of those "
            f"with a gradient above {tol} of its tensor's largest (tol {tol} for loss, logits "
            "and gradients; 0 such params)")
        if not (e["loss"] <= tol and e["logits"] <= tol and e["grad"] <= tol
                and e["grad_l2"] <= tol and e["param"] <= 2 * cfg.learning_rate * 1.01
                and e["param_unexplained"] == 0):
            raise AssertionError(f"vivit-train {dtype} step card vs CPU: {e}")
        if dtype == "bfloat16":
            # K2's q/k/v gradients at the training shapes: strided qkv views
            # (16, 80, 768), against autograd through _mha_einsum
            qkv = gpu["qkv"].requires_grad_()
            out = att.small_mha(*qkv.chunk(3, dim=-1), cfg.num_heads)
            (g_kernel,) = torch.autograd.grad(out, qkv, gpu["g_attn"])
            qkv2 = gpu["qkv"].detach().clone().requires_grad_()
            ref = att._mha_einsum(*qkv2.chunk(3, dim=-1), cfg.num_heads, False)
            (g_plain,) = torch.autograd.grad(ref, qkv2, gpu["g_attn"])
            log("vivit-train", f"K2 under autograd on block 0's qkv views {tuple(qkv.shape)} "
                f"bf16 (strides {qkv.chunk(3, dim=-1)[0].stride()}): q/k/v gradients bit-equal "
                f"to autograd through _mha_einsum: {torch.equal(g_kernel, g_plain)}; forward "
                f"max|d| {(out.float() - ref.float()).abs().max().item():.3g}")
            if not torch.equal(g_kernel, g_plain):
                raise AssertionError("K2's q/k/v gradients differ from _mha_einsum autograd")
        del gpu, cpu

    # 2. the CLI, through the user's entry point
    per_step = []

    class StepRecorder:
        def write(self, step, metrics):
            per_step.append((step, metrics["loss"]))

    real_train = tv.train

    def recording_train(*args, metrics_writer=None, **kwargs):
        metrics_writer.writers.append(StepRecorder())
        return real_train(*args, metrics_writer=metrics_writer, **kwargs)

    argv = ["train-vivit", "--steps", str(VT_CLI_STEPS), "--set", "vivit.num_classes=8"]
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    tv.train = recording_train
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        tv.train = real_train
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"small_mha": att.small_mha.launch_count}
    routes = dict(att.small_mha.route_counts)
    best_line = [ln for ln in out.getvalue().splitlines() if ln.startswith("best: ")]
    if rc != 0 or len(best_line) != 1:
        raise AssertionError(f"cli.main({argv}) returned {rc}, printed {out.getvalue()!r}")
    best = ast.literal_eval(best_line[0][len("best: "):])
    steps_per_epoch = 512 // base.batch_size
    epochs = max(1, VT_CLI_STEPS // steps_per_epoch)
    n_steps, n_evals = epochs * steps_per_epoch, epochs * steps_per_epoch
    want_k2 = base.num_layers * (n_steps + n_evals)
    if [s for s, _ in per_step] != list(range(1, n_steps + 1)):
        raise AssertionError(f"per-step metrics at steps {[s for s, _ in per_step][:5]}..., "
                             f"want 1..{n_steps}")
    if routes != {"sm90": want_k2, "cuda_core": 0} or launches["small_mha"] != want_k2:
        raise AssertionError(f"train-vivit launched K2 {launches['small_mha']}x by {routes}, "
                             f"want {want_k2} by sm90 (12 a step and an eval batch)")
    epoch_loss = []
    for e in range(epochs):
        rm = RunningMean()
        for _, loss in per_step[e * steps_per_epoch:(e + 1) * steps_per_epoch]:
            rm.update({"loss": loss})
        epoch_loss.append(rm.means()["loss"])
    console = [ln for ln in err.getvalue().splitlines() if ln.startswith("[step ")]
    log("vivit-train", f"cli.main({argv}): {n_steps} steps in {epochs} epochs, {n_evals} eval "
        f"batches, {cli_s:.2f} s; K2 {launches['small_mha']}x (routes {routes}: 12 a step and an "
        f"eval batch, all sm90); {len(per_step)} per-step metric writes, console every 10 "
        f"(last: {console[-1] if console else None}); mean loss by epoch "
        f"{[round(x, 5) for x in epoch_loss]}; {best_line[0]}")
    if not (epoch_loss[-1] < epoch_loss[0] and best["accuracy"] > 1 / 8):
        raise AssertionError(f"train-vivit did not learn: epoch losses {epoch_loss}, best {best}")

    # 3. timing at batch 16 and 384: batches staged on the card, CUDA events
    # around n steps, no host sync inside the window
    timing = {}
    state = tv.create_state(base, seed=SEED, device="cuda")
    state.model.load_state_dict(sd)
    for b, n in ((VT_BATCH, 20), (VT_SERVE_BATCH, 10)):
        staged = [{k: torch.as_tensor(v).to("cuda") for k, v in _vt_batch(b, SEED + 50 + i).items()}
                  for i in range(2)]
        for i in range(3):
            tv.train_step(state, staged[i % 2])                             # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for i in range(n):
            tv.train_step(state, staged[i % 2])
        stop.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        step_ms = start.elapsed_time(stop) / n
        peak = torch.cuda.max_memory_allocated() / 2**20
        busy_ms = _profile_step("vivit-train", lambda: tv.train_step(state, staged[0])[
            "loss"].item(), f"batch-{b} step")
        k2_ms, k2_n = _profile_step.own["K2"]
        timing[b] = {"step_ms": step_ms, "clips_s": b / step_ms * 1e3, "peak_mib": peak,
                     "busy": busy_ms / step_ms, "k2_share": k2_ms / busy_ms}
        log("vivit-train", f"batch {b} ({dev['smi']}): {n} steps, {step_ms:.3f} ms a step by CUDA "
            f"events ({host_ms:.3f} ms by the host clock) = {b / step_ms * 1e3:.1f} trained "
            f"clips/s; peak device memory {peak:.1f} MiB; the profiled step's "
            f"{busy_ms:.3f} ms of kernels and copies are {busy_ms / step_ms:.3f} of a step; K2 "
            f"{k2_ms:.4f} ms ({k2_ms / busy_ms:.1%}, {k2_n}x)")
    log("vivit-train", f"phase took {time.perf_counter() - phase_t0:.1f} s")
    return {"launches": launches, "timing": timing}


# Lipreading end to end (phase [lipread-e2e]): synthetic LRS2-style records
# fed from memory through lipreading_e2e.run(read_frames=...), at the full
# widths of S3FD, the ViViT defaults and the NeuralScorer defaults.
LR_RECORDS, LR_FRAMES, LR_HW = 12, 40, 160
LR_WORDS = ("ABOUT", "AFTER", "AGAIN", "ALWAYS", "BECAUSE", "BEFORE", "COULD", "EVERY",
            "FIRST", "GOING", "GREAT", "HOUSE", "LITTLE", "MIGHT", "NEVER", "OTHER",
            "PEOPLE", "RIGHT", "SHOULD", "THINK", "THREE", "WATER", "WHERE", "WORLD")
LR_LANDMARK_STEPS, LR_LANDMARK_RECORDS = 48, 3
# S3FD heads, card (cuDNN without TF32) vs CPU: float32 sums in another
# order through 19 convolutions and an L2Norm; of each head's largest |value|.
TOL_S3FD = 1e-3
# face tracks (box coordinates in pixels) from those heads: decoded through
# exp(), averaged over 5 frames
TOL_TRACK_PX = 1e-2
# word-LM scores (length-normalised log-likelihoods), card (K2 by its
# CUDA-core route, cuBLAS without TF32) vs CPU (_mha_einsum) on the same
# weights: float32 sums in another order through 2 blocks and a log-softmax.
TOL_LM_SCORE = 1e-4


def lipread_records(root: str, seed: int) -> dict:
    """``LR_RECORDS`` LRS2-style records under ``root``: an empty ``.mp4``
    (the manifest wants one) and a transcript with word timings at 25 fps
    each; returns video path → (LR_FRAMES, LR_HW, LR_HW, 3) RGB uint8 frames
    of a drawn face (head, eyes, a mouth that opens and closes), which
    ``run`` reads through ``read_frames``."""
    import os

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:LR_HW, 0:LR_HW].astype(np.float32)
    frames_of = {}
    for i in range(LR_RECORDS):
        d = os.path.join(root, f"spk{i:02d}")
        os.makedirs(d)
        words = list(rng.choice(LR_WORDS, int(rng.integers(3, 6))))
        bounds = np.linspace(0, LR_FRAMES, len(words) + 1).round().astype(int)
        with open(os.path.join(d, "00001.txt"), "w") as f:
            f.write(f"Text:  {' '.join(words)}\n\nConf: 4\n\nWORD START END SCORE\n")
            for w, a, b in zip(words, bounds[:-1], bounds[1:]):
                f.write(f"{w} {a / 25.0:.2f} {b / 25.0:.2f} 1.0\n")
        path = os.path.join(d, "00001.mp4")
        open(path, "w").close()
        cy, cx = 80 + rng.uniform(-6, 6), 80 + rng.uniform(-6, 6)
        skin = rng.uniform(150, 210, 3)
        frames = rng.integers(0, 90, (LR_FRAMES, LR_HW, LR_HW, 3)).astype(np.float32)
        for t in range(LR_FRAMES):
            oy, ox = cy + rng.uniform(-1.5, 1.5), cx + rng.uniform(-1.5, 1.5)
            head = ((xx - ox) / 42) ** 2 + ((yy - oy) / 55) ** 2 <= 1
            frames[t][head] = skin
            for ex in (-16, 16):
                frames[t][((xx - ox - ex) / 7) ** 2 + ((yy - oy + 14) / 4) ** 2 <= 1] = 30
            mh = 2 + 6 * abs(math.sin(0.7 * t + i))
            frames[t][((xx - ox) / 14) ** 2 + ((yy - oy - 28) / mh) ** 2 <= 1] = (90, 20, 30)
        frames_of[path] = np.clip(frames + rng.normal(0, 4, frames.shape), 0, 255).astype(np.uint8)
    return frames_of


class _Stage:
    """Wraps ``module.name`` for the duration of a ``with``: the wall time of
    each call (between ``torch.cuda.synchronize()``s) and the K1/K2
    launches by route made inside the calls."""

    def __init__(self, module, name: str):
        self.module, self.name, self.real = module, name, getattr(module, name)
        self.times = []
        self.k1 = self.k2_sm90 = self.k2_cuda_core = 0

    @property
    def calls(self) -> int:
        return len(self.times)

    @property
    def seconds(self) -> float:
        return sum(self.times)

    def ms(self) -> str:
        """First call and the median of the others, ms."""
        rest = statistics.median(self.times[1:]) if len(self.times) > 1 else float("nan")
        return f"first {self.times[0] * 1e3:.3f} ms, then median {rest * 1e3:.3f} ms"

    def __enter__(self):
        from lipreading_video_generation_tpu_torch.ops import attention as att
        from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            before = (cl.clahe_cuda.route_counts["packed"], att.small_mha.route_counts["sm90"],
                      att.small_mha.route_counts["cuda_core"])
            t0 = time.perf_counter()
            out = self.real(*args, **kwargs)
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - t0)
            self.k1 += cl.clahe_cuda.route_counts["packed"] - before[0]
            self.k2_sm90 += att.small_mha.route_counts["sm90"] - before[1]
            self.k2_cuda_core += att.small_mha.route_counts["cuda_core"] - before[2]
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def phase_lipread_e2e(dev: dict) -> dict:
    import copy
    import tempfile

    from lipreading_video_generation_tpu_torch.core.config import Config
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.data.manifest import build_manifest
    from lipreading_video_generation_tpu_torch.models import s3fd as s3fd_mod
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.pipelines import inference as inf
    from lipreading_video_generation_tpu_torch.pipelines import lipreading_e2e as e2e
    from lipreading_video_generation_tpu_torch.pipelines import preprocess as pre
    from lipreading_video_generation_tpu_torch.pipelines import sentence_eval as se
    from lipreading_video_generation_tpu_torch.pipelines import train_landmark as tl
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as tv

    phase_t0 = time.perf_counter()
    cfg = Config()
    with tempfile.TemporaryDirectory() as root:
        frames_of = lipread_records(root, SEED + 60)
        read_frames = lambda path: (frames_of[path], 25.0)   # noqa: E731
        records, _ = build_manifest(root, require_transcript=True)
        n_words = sum(len(r.words) for r in records)
        log("lipread-e2e", f"{len(records)} records of {LR_FRAMES} frames of {LR_HW}x{LR_HW} RGB, "
            f"{n_words} words over a vocabulary of {len(LR_WORDS)}, fed from memory; S3FD "
            f"(VGG16) at batch {cfg.preprocess.face_det_batch_size}, ViViTConfig defaults "
            f"(layers={cfg.vivit.num_layers} hidden={cfg.vivit.hidden_size} "
            f"heads={cfg.vivit.num_heads} {cfg.vivit.dtype}), NeuralScorer defaults (hidden 64, "
            f"2 layers, 4 heads, max_len 32, 400 steps), beam {cfg.sentence_eval.beam_width} "
            f"keep {cfg.sentence_eval.keep_top}")

        # 1. the whole chain through lipreading_e2e.run, stages timed
        stages = {"detect": _Stage(inf, "detect_face_tracks"),
                  "roi": _Stage(pre, "mouth_roi_pipeline_from_boxes"),
                  "vivit_step": _Stage(tv, "train_step"), "vivit_eval": _Stage(tv, "eval_step"),
                  "predict": _Stage(tv, "predict_step"),
                  "scorer_fit": _Stage(se, "fit_default_scorer"),
                  "beam": _Stage(se, "beam_search")}
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for stage in stages.values():
                stack.enter_context(stage)
            state, stats = e2e.run(cfg, root, num_epochs=2, read_frames=read_frames,
                                   device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {"clahe": cl.clahe_cuda.launch_count, "small_mha": att.small_mha.launch_count}
        k1_routes, k2_routes = dict(cl.clahe_cuda.route_counts), dict(att.small_mha.route_counts)
        s = stages
        n_layers = cfg.vivit.num_layers
        want_vivit = n_layers * (s["vivit_step"].calls + s["vivit_eval"].calls
                                 + s["predict"].calls)
        vivit_sm90 = s["vivit_step"].k2_sm90 + s["vivit_eval"].k2_sm90 + s["predict"].k2_sm90
        lm_cuda_core = s["scorer_fit"].k2_cuda_core + s["beam"].k2_cuda_core
        n_levels = n_words            # one batched scorer call a word slot
        want_lm = 2 * (400 + n_levels)
        log("lipread-e2e", f"run: {run_s:.2f} s; word accuracy {stats['accuracy']:.4f}, sentence "
            f"accuracy {stats['sentence_accuracy']:.4f}; K1 {launches['clahe']}x (routes "
            f"{k1_routes}), K2 {launches['small_mha']}x (routes {k2_routes}): ViViT {vivit_sm90} "
            f"by sm90 (want {want_vivit}), word LM {lm_cuda_core} by cuda_core (want {want_lm}: 2 "
            f"layers x (400 steps + {n_levels} beam levels))")
        det, roi, step, beam = s["detect"], s["roi"], s["vivit_step"], s["beam"]
        det_med = statistics.median(det.times[1:])
        log("lipread-e2e", f"stages ({dev['smi']}): detection {det.calls} clips of {LR_FRAMES} "
            f"frames in {det.seconds:.3f} s ({det.ms()} a clip = {LR_FRAMES / det_med:.1f} "
            f"frames/s); ROI {roi.calls} clips in {roi.seconds:.3f} s ({roi.ms()} a clip = "
            f"{1 / statistics.median(roi.times[1:]):.1f} clips/s, K1 {roi.k1}x); ViViT "
            f"{step.calls} train steps ({step.ms()} a step, K2 {step.k2_sm90}x sm90), "
            f"{s['vivit_eval'].calls} eval batches, predict of {n_words} clips "
            f"{s['predict'].seconds * 1e3:.3f} ms; scorer fit "
            f"{s['scorer_fit'].seconds:.3f} s (K2 {s['scorer_fit'].k2_cuda_core}x cuda_core); "
            f"beam search {beam.calls} sentences in {beam.seconds:.3f} s ({beam.ms()} a sentence, "
            f"K2 {beam.k2_cuda_core}x cuda_core)")
        if not (0.0 <= stats["accuracy"] <= 1.0 and 0.0 <= stats["sentence_accuracy"] <= 1.0):
            raise AssertionError(f"lipread-e2e: accuracies out of [0, 1]: {stats}")
        if k1_routes != {"packed": len(records), "tiled": 0} or roi.k1 != len(records):
            raise AssertionError(f"lipread-e2e: K1 routes {k1_routes}, want one packed launch a "
                                 f"clip ({len(records)})")
        if (vivit_sm90 != want_vivit or lm_cuda_core != want_lm
                or k2_routes != {"sm90": want_vivit, "cuda_core": want_lm}):
            raise AssertionError(f"lipread-e2e: K2 routes {k2_routes}, ViViT {vivit_sm90} "
                                 f"(want {want_vivit} by sm90), word LM {lm_cuda_core} "
                                 f"(want {want_lm} by cuda_core)")
        if s["beam"].calls != len(records):
            raise AssertionError(f"beam search ran {s['beam'].calls} times for {len(records)} "
                                 "sentences")

        # 2. a second pass over a few records with a trained landmark net
        t0 = time.perf_counter()
        lm_state = tl.train(num_steps=LR_LANDMARK_STEPS, batch_size=64, seed=SEED, log_every=0,
                            device="cuda")
        torch.cuda.synchronize()
        lm_train_s = time.perf_counter() - t0
        k1_before = cl.clahe_cuda.route_counts["packed"]
        t0 = time.perf_counter()
        ds = e2e.build_word_clip_dataset(cfg, records[:LR_LANDMARK_RECORDS],
                                         landmark_params=lm_state.model, read_frames=read_frames,
                                         device="cuda")
        torch.cuda.synchronize()
        lm_pass_s = time.perf_counter() - t0
        k1_landmark = cl.clahe_cuda.route_counts["packed"] - k1_before
        launches["clahe"] = cl.clahe_cuda.launch_count
        want_clips = sum(len(r.words) for r in records[:LR_LANDMARK_RECORDS])
        log("lipread-e2e", f"landmark pass: train_landmark.train {LR_LANDMARK_STEPS} steps at "
            f"batch 64, width 32 in {lm_train_s:.2f} s; build_word_clip_dataset over "
            f"{LR_LANDMARK_RECORDS} records with its net in {lm_pass_s:.3f} s: {len(ds.clips)} "
            f"word clips (want {want_clips}), K1 {k1_landmark}x by packed")
        if (k1_landmark != LR_LANDMARK_RECORDS or len(ds.clips) != want_clips
                or any(c.shape != (cfg.vivit.num_frames, 32, 32, 1) or c.dtype != np.uint8
                       for c in ds.clips)):
            raise AssertionError(f"landmark pass: K1 {k1_landmark}x, {len(ds.clips)} clips")

        # 3. card against the port's own CPU run, same weights and inputs
        det_gpu = seeded(s3fd_mod.S3FD, 0).to("cuda").eval()
        det_cpu = seeded(s3fd_mod.S3FD, 0).eval()
        frames0 = frames_of[records[0].video_path]
        batch = torch.from_numpy(np.ascontiguousarray(
            frames0[:cfg.preprocess.face_det_batch_size, :, :, ::-1]))
        with torch.no_grad():
            heads_gpu = det_gpu(s3fd_mod.preprocess_input(batch.to("cuda")))
            heads_cpu = det_cpu(s3fd_mod.preprocess_input(batch))
        worst = max((g.cpu() - c).abs().max().item() / c.abs().max().item()
                    for g, c in zip(heads_gpu, heads_cpu))
        _, _, valid = s3fd_mod.detect_faces(det_gpu, batch.to("cuda"),
                                            cfg.preprocess.face_det_score_threshold,
                                            cfg.preprocess.nms_threshold)
        # record 0's face tracks, then its ROI from the card's mouth boxes on both
        # sides (boxes that differ by float noise can move a gray value across a
        # histogram bin and a tile's LUT by several levels, tests/test_torch_port_slice.py)
        pcfg = cfg.preprocess
        tracks_gpu = inf.detect_face_tracks(det_gpu, frames0, pcfg)
        tracks_cpu = inf.detect_face_tracks(det_cpu, frames0, pcfg)
        track_d = (tracks_gpu.cpu() - tracks_cpu).abs().max().item()
        mouth = pre.mouth_box_from_face(tracks_gpu, pcfg.lip_crop_size[0])
        roi_args = (pcfg.lip_crop_size, pcfg.model_input_size, pcfg.clahe_clip_limit,
                    pcfg.clahe_grid)
        roi_gpu = pre.mouth_roi_pipeline_from_boxes(torch.from_numpy(frames0).to("cuda"), mouth,
                                                    *roi_args).cpu()
        roi_cpu = pre.mouth_roi_pipeline_from_boxes(torch.from_numpy(frames0), mouth.cpu(),
                                                    *roi_args)
        d = (roi_gpu.int() - roi_cpu.int()).abs().numpy()
        within1 = float((d <= 1).mean())
        scorer = se.NeuralScorer(device="cuda").fit([r.text for r in records])
        cpu_scorer = copy.copy(scorer)
        cpu_scorer.model = copy.deepcopy(scorer.model).cpu()
        cpu_scorer.device = torch.device("cpu")
        level = [f"{a} {b}" for a in LR_WORDS[:10] for b in LR_WORDS[10:20]]   # a beam level
        sc_gpu = np.array(scorer.score_batch(level))
        sc_cpu = np.array(cpu_scorer.score_batch(level))
        lm_d = float(np.abs(sc_gpu - sc_cpu).max())
        log("lipread-e2e", f"card vs CPU: S3FD's 12 heads on a batch of "
            f"{cfg.preprocess.face_det_batch_size} frames max|d| {worst:.3g} of each head's "
            f"max|ref| (tol {TOL_S3FD}), {int(valid.sum())} valid detections (random weights: "
            f"faces not required); record 0's face tracks max|d| {track_d:.3g} px (tol "
            f"{TOL_TRACK_PX}); its {LR_FRAMES} ROI frames from the same mouth boxes max|d| "
            f"{d.max()} levels, {within1:.5f} within 1 (want max <= 2, >= 0.99); word-LM scores of "
            f"a beam level of {len(level)} sentences max|d| {lm_d:.3g} (tol {TOL_LM_SCORE})")
        if not (worst <= TOL_S3FD and track_d <= TOL_TRACK_PX and d.max() <= 2
                and within1 >= 0.99 and lm_d <= TOL_LM_SCORE):
            raise AssertionError(f"lipread-e2e card vs CPU: heads {worst}, tracks {track_d}, ROI "
                                 f"{d.max()} / {within1}, LM scores {lm_d}")
    log("lipread-e2e", f"phase took {time.perf_counter() - phase_t0:.1f} s")
    return {"launches": launches}


def flax_unet_audio_params(cfg, seed: int) -> dict:
    """Random weights in the tree and shapes of the Flax ``UNetAudio(cfg)``
    (native audio encoder; the card's machine has no flax): conv and Dense
    kernels ~ N(0, 1/fan_in), the layers Flax zero-initialises (each
    ResBlock's second conv, each attention projection, the output conv) at
    a fifth of that so that they still act, small biases, norm scales near 1."""
    from lipreading_video_generation_tpu_torch.models.audio_encoder import num_tokens
    from lipreading_video_generation_tpu_torch.models.unet import plan

    rng = np.random.default_rng(seed)

    def kernel(shape, fan_in, gain=1.0):
        return (gain * rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)

    def bias(n):
        return (0.02 * rng.standard_normal(n)).astype(np.float32)

    def dense(n_in, n_out, gain=1.0):
        return {"kernel": kernel((n_in, n_out), n_in, gain), "bias": bias(n_out)}

    def conv(kh, kw, c_in, c_out, gain=1.0):
        return {"kernel": kernel((kh, kw, c_in, c_out), kh * kw * c_in, gain), "bias": bias(c_out)}

    def norm(n):
        return {"scale": (1 + 0.05 * rng.standard_normal(n)).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(n)).astype(np.float32)}

    e = cfg.audio_embed_dim
    enc = {"Conv_0": {"kernel": kernel((5, 80, e // 2), 5 * 80), "bias": bias(e // 2)},
           "Conv_1": {"kernel": kernel((3, e // 2, e), 3 * e // 2), "bias": bias(e)},
           "LayerNorm_0": norm(e), "LayerNorm_1": norm(e),
           "pos_embedding": (0.02 * rng.standard_normal(
               (1, num_tokens(cfg.audio_samples), e))).astype(np.float32)}
    for i in range(4):
        enc[f"block_{i}"] = {"LayerNorm_0": norm(e), "qkv": dense(e, 3 * e), "proj": dense(e, e),
                             "LayerNorm_1": norm(e),
                             "MLP_0": {"Dense_0": dense(e, 4 * e), "Dense_1": dense(4 * e, e)}}
    base, ted = cfg.base_channels, cfg.time_embed_dim
    c_in = cfg.im_channels + cfg.audio_proj_dim + cfg.im_cond_channels
    unet = {"Dense_0": dense(base, ted), "Dense_1": dense(ted, ted),
            "Conv_0": conv(3, 3, c_in, base),
            "GroupNorm_0": norm(base * cfg.channel_mult[0]),
            "Conv_1": conv(3, 3, base * cfg.channel_mult[0], cfg.im_channels, 0.2)}
    count = {"res": 0, "attn": 0, "down": 0, "up": 0}
    names = {"res": "ResBlock", "attn": "AttentionBlock", "down": "Downsample", "up": "Upsample"}
    for step in plan(base, cfg.channel_mult, cfg.num_res_blocks, cfg.attention_resolutions):
        kind = step[0]
        if kind not in names:
            continue
        name = f"{names[kind]}_{count[kind]}"
        count[kind] += 1
        if kind == "res":
            ci, co = step[1], step[2]
            p = {"GroupNorm_0": norm(ci), "Conv_0": conv(3, 3, ci, co), "Dense_0": dense(ted, 2 * co),
                 "GroupNorm_1": norm(co), "Conv_1": conv(3, 3, co, co, 0.2)}
            if ci != co:
                p["Conv_2"] = conv(1, 1, ci, co)
        elif kind == "attn":
            c = step[1]
            p = {"GroupNorm_0": norm(c), "qkv": dense(c, 3 * c), "proj": dense(c, c, 0.2)}
        else:
            p = {"Conv_0": conv(3, 3, step[1], step[1])}
        unet[name] = p
    return {"audio_encoder": enc, "audio_proj": dense(e, cfg.audio_proj_dim),
            "im_cond_conv": conv(1, 1, cfg.im_channels, cfg.im_cond_channels), "unet": unet}


def diffusion_inputs(cfg, n_frames: int, seed: int):
    """A random 160×160 RGB uint8 condition frame (resized to im_size on the
    way in) and ``n_frames`` random 4000-sample audio windows."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (160, 160, 3), dtype=np.uint8)
    audio = rng.standard_normal((n_frames, cfg.audio_samples)).astype(np.float32)
    return frame, audio


def _load_unet_audio(cfg, state, device):
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio

    model = UNetAudio(cfg).eval()
    model.load_state_dict(state)
    return model.to(device)


def phase_diffuse(dev: dict) -> dict:
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig
    from lipreading_video_generation_tpu_torch.models.convert import (
        unet_audio_state_dict_from_flax)
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops.image import denormalize_to_uint8
    from lipreading_video_generation_tpu_torch.pipelines.sample_diffusion import (
        sample, sample_video)

    cfg = DiffusionConfig()
    state = unet_audio_state_dict_from_flax(flax_unet_audio_params(cfg, SEED), cfg)
    model = _load_unet_audio(cfg, state, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    n_attn = sum(type(m).__name__ == "AttentionBlock" for m in model.modules())
    if n_attn != 16:
        raise AssertionError(f"{n_attn} AttentionBlocks at the defaults, want 16")
    log("diffuse", f"DiffusionConfig defaults: {cfg.im_size}x{cfg.im_size}, base "
        f"{cfg.base_channels}, channel_mult {cfg.channel_mult}, {cfg.num_res_blocks} res "
        f"blocks, attention at ds {cfg.attention_resolutions} ({n_attn} AttentionBlocks), "
        f"{cfg.num_heads} head, {cfg.dtype}, native audio encoder; {n_params} params from "
        "seeded numpy via unet_audio_state_dict_from_flax")
    frame, audio = diffusion_inputs(cfg, DIFF_FRAMES, SEED)
    gen = torch.Generator("cuda")

    def request(sampler):
        return sample_video(model, frame, audio, cfg, num_inference_steps=DIFF_STEPS,
                            sampler=sampler, generator=gen.manual_seed(SEED))

    # warm-up (cuDNN, allocator): the same request through ``sample`` with
    # float frames out, which must be finite (uint8 frames cannot show a NaN)
    cond = torch.as_tensor(frame)[None].expand((DIFF_FRAMES,) + frame.shape)
    warm, _ = sample(model, cond, audio, cfg, num_inference_steps=DIFF_STEPS,
                     snapshot_every=cfg.num_timesteps + 1, generator=gen.manual_seed(SEED))
    if not bool(torch.isfinite(warm).all()):
        raise AssertionError("diffusion request gave non-finite frames")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times = []
    for sampler in ("ddim", "ddim", "ddim", "dpmpp"):
        k1, k2, k3 = (cl.clahe_cuda.launch_count, att.small_mha.launch_count,
                      att.flash_attention.launch_count)
        t0 = time.perf_counter()
        out = request(sampler).cpu()
        times.append(time.perf_counter() - t0)
        d = (cl.clahe_cuda.launch_count - k1, att.small_mha.launch_count - k2,
             att.flash_attention.launch_count - k3)
        if d != (0, 4, n_attn * DIFF_STEPS):
            raise AssertionError(f"{sampler} request launched K1/K2/K3 {d}, want "
                                 f"(0, 4, {n_attn * DIFF_STEPS})")
        if out.dtype != torch.uint8 or tuple(out.shape) != (DIFF_FRAMES, 128, 128, 3):
            raise AssertionError(f"bad frames {out.dtype} {tuple(out.shape)}")
        if sampler == "ddim":     # same seed as the warm-up: the same frames
            same = (out.int() - denormalize_to_uint8(warm).cpu().int()).abs().max().item()
            if same > 1:
                raise AssertionError(f"ddim request differs from its float warm-up by {same}")
    launches = {"small_mha": att.small_mha.launch_count,
                "flash_attention": att.flash_attention.launch_count}
    peak = torch.cuda.max_memory_allocated()
    _all_by_tensor_cores("diffuse", att.flash_attention, att.small_mha)
    log("diffuse", f"4 requests (ddim x3, dpmpp) of {DIFF_FRAMES} frames x {DIFF_STEPS} "
        f"steps: launches K1=0 K2={launches['small_mha']} K3={launches['flash_attention']} "
        f"(4 and {n_attn}x{DIFF_STEPS} per request; K3 routes "
        f"{att.flash_attention.route_counts}, K2 routes {att.small_mha.route_counts}); uint8 frames "
        f"{tuple(out.shape)}, pixel mean {out.float().mean().item():.2f}")

    # where the time of a DDIM request goes
    busy_ms = _profile_step("diffuse", lambda: request("ddim").cpu(), "request")

    # the full DDPM ancestral chain (500 steps) at batch 1
    k2, k3 = att.small_mha.launch_count, att.flash_attention.launch_count
    t0 = time.perf_counter()
    chain = sample_video(model, frame, audio[:1], cfg, generator=gen.manual_seed(SEED)).cpu()
    chain_s = time.perf_counter() - t0
    d = (att.small_mha.launch_count - k2, att.flash_attention.launch_count - k3)
    if d != (4, n_attn * cfg.num_timesteps) or tuple(chain.shape) != (1, 128, 128, 3):
        raise AssertionError(f"DDPM chain launched K2/K3 {d}, gave {tuple(chain.shape)}")
    _all_by_tensor_cores("diffuse", att.flash_attention)
    log("diffuse", f"full DDPM chain, batch 1, {cfg.num_timesteps} steps: {chain_s:.3f} s "
        f"({cfg.num_timesteps / chain_s:.2f} frame-steps/s), K2={d[0]} K3={d[1]} launches "
        f"(K3 routes {att.flash_attention.route_counts}), "
        f"uint8 frame pixel mean {chain.float().mean().item():.2f}")

    # the card against the CPU plain path: 64x64, batch 1, 2 DDIM steps
    cfg64 = dataclasses.replace(cfg, im_size=64)
    noise = np.random.default_rng(SEED + 1).standard_normal((1, 64, 64, 3)).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        m = _load_unet_audio(cfg64, state, device)
        x0, _ = sample(m, frame[None], audio[:1], cfg64, num_inference_steps=2, noise=noise)
        outs[device] = x0.cpu()
        del m
    diff = (outs["cuda"] - outs["cpu"]).abs()
    log("diffuse", f"64x64, batch 1, 2 DDIM steps, card vs CPU plain path: frames max|d| "
        f"{diff.max().item():.4g}, mean|d| {diff.mean().item():.4g} (tol {TOL_FRAMES} abs); "
        f"finite {bool(torch.isfinite(outs['cuda']).all())}")
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0, atol=TOL_FRAMES)

    per_req = statistics.median(times[:3])
    log("diffuse", f"request times ({dev['smi']}): ddim {[round(t * 1e3, 3) for t in times[:3]]} "
        f"ms, dpmpp {times[3] * 1e3:.3f} ms; ddim median {per_req * 1e3:.3f} ms = "
        f"{DIFF_FRAMES * DIFF_STEPS / per_req:.2f} denoise frame-steps/s (the profiled "
        f"request's {busy_ms:.3f} ms of kernels are {busy_ms / (per_req * 1e3):.3f} of it); "
        f"peak device memory {peak / 2**20:.1f} MiB")
    return launches


def _counts() -> dict:
    from lipreading_video_generation_tpu_torch.ops import attention as att

    return {"small_mha": att.small_mha.launch_count,
            "flash_attention": att.flash_attention.launch_count,
            "flash_bwd_dkv": att.flash_bwd_dkv.launch_count,
            "flash_bwd_dq": att.flash_bwd_dq.launch_count}


def _zero_counts() -> None:
    for fn in _kernel_wrappers():
        fn.launch_count = 0
        if hasattr(fn, "pack_launch_count"):
            fn.pack_launch_count = 0
        for counts in ("route_counts", "variant_counts", "path_counts"):
            if hasattr(fn, counts):
                setattr(fn, counts, dict.fromkeys(getattr(fn, counts), 0))


def _all_by_tensor_cores(phase: str, *fns) -> None:
    """Every launch of ``fns`` since ``_zero_counts`` took the tensor-core
    route (``route_counts`` beside ``launch_count``)."""
    for fn in fns:
        others = sum(n for r, n in fn.route_counts.items() if r != "sm90")
        if fn.route_counts["sm90"] != fn.launch_count or others or fn.launch_count < 1:
            raise AssertionError(f"{phase}: {fn.__name__} took the routes {fn.route_counts} in "
                                 f"{fn.launch_count} launches, want all by the tensor cores")


def _k2_rows_phase(phase: str, run) -> dict:
    """Run a phase whose float32 K2 launches are a main path's, and check
    that its CUDA-core launches went through the rows_vec4 variant of
    ``csrc/small_mha.cu``; log them by variant."""
    from lipreading_video_generation_tpu_torch.ops import attention as att

    before = dict(att.small_mha.variant_counts)
    out = run()
    took = {v: n - before[v] for v, n in att.small_mha.variant_counts.items() if n != before[v]}
    log(phase, f"K2 by cuda_core, launches by variant: {took}")
    if not took.get("rows_vec4"):
        raise AssertionError(f"{phase}: K2's CUDA-core launches took the variants {took}, want "
                             "the main path's by rows_vec4")
    return out


# the float32 diffusion steps' launches of the combine kernel, tallied by
# _flash_tiled (those steps are its main path)
TILED_COMBINES = {"flash_fwd_combine": 0}


def _flash_variants() -> dict:
    """K3's, K4's and K5's CUDA-core launches so far, by variant of
    ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, and the launches of
    K3's combine kernel."""
    from lipreading_video_generation_tpu_torch.ops import attention as att

    return {"flash_attention": dict(att.flash_attention.variant_counts),
            "flash_bwd_dkv": dict(att.flash_bwd_dkv.variant_counts),
            "flash_bwd_dq": dict(att.flash_bwd_dq.variant_counts),
            "flash_fwd_combine": {"launches": att.flash_fwd_combine.launch_count}}


def _flash_tiled(phase: str, what: str, took: dict) -> None:
    """Fail unless K3's, K4's and K5's CUDA-core launches in ``took`` (by
    kernel, then by variant, as ``_flash_variants`` gives them) are some, and
    all by the "tiled" variant: a float32 diffusion step on the main path.
    Logs them, and tallies the combine kernel's launches."""
    log(phase, f"{what}: K3/K4/K5 by cuda_core, launches by variant: {took}")
    for name, by_variant in took.items():
        if name == "flash_fwd_combine":
            TILED_COMBINES[name] += by_variant.get("launches", 0)
        elif not by_variant.get("tiled") or any(n for v, n in by_variant.items() if v != "tiled"):
            raise AssertionError(f"{phase}: {what}: {name} took the variants {by_variant}, want "
                                 "every launch by tiled")


def _tiled_run(phase: str, what: str, run):
    """``run()``, then ``_flash_tiled`` on the K3/K4/K5 launches it made."""
    before = _flash_variants()
    out = run()
    after = _flash_variants()
    _flash_tiled(phase, what, {k: {v: n - before[k][v] for v, n in after[k].items()
                                   if n != before[k][v]} for k in after})
    return out


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def _train_routes() -> dict:
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

    return dict(ttd.train_step.route_counts)


# K2-K5's tensor-core kernels by name: what the training paths launch
TRAIN_KERNELS = {"small_mha": "small_mha_sm90_kernel", "flash_attention": "flash_fwd_sm90_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_sm90_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_sm90_kernel"}


def _traced_launches(fn) -> tuple:
    """``fn()`` (and a wait for the card) under a CUDA-only ``torch.profiler``
    trace → (its result, the launches of each of ``TRAIN_KERNELS`` the card
    ran, by name). The wrappers count the launches made from Python outside
    a capture; a replayed CUDA graph launches its kernels again without
    them, and only a device trace sees those."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return out, {k: sum(n for name, n in rows if frag in name)
                 for k, frag in TRAIN_KERNELS.items()}


def _with_replays(counted: dict, per_step: dict, replays: int) -> dict:
    """The rule for graphed training steps: what a device trace of a run
    must hold, from the launches the wrappers counted in it (its eager
    steps and evals; a capture runs nothing and counts nothing) and
    ``replays`` replays of a captured step of ``per_step`` launches."""
    return {k: n + per_step.get(k, 0) * replays for k, n in counted.items()}


def train_batch(cfg, n: int, seed: int, size: int = 160) -> dict:
    """Random ``size``×``size`` RGB uint8 target and condition frames
    (resized to im_size on the way in) and ``n`` random audio windows."""
    rng = np.random.default_rng(seed)
    return {"target_frame": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "cond_frame": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "audio": rng.standard_normal((n, cfg.audio_samples)).astype(np.float32)}


# kernel-name fragments of the hand-written kernels, for the profiles
KERNEL_NAMES = {"K1": "clahe_", "K2": "small_mha_", "K3": "flash_fwd_",
                "K4": "flash_bwd_dkv", "K5": "flash_bwd_dq", "K6": "::mm_"}
# ops/quant's ranges around an int8 product's stages (its int8/weights range,
# a weight's quantisation on first use, is not a stage)
INT8_STAGES = ("int8/quantise", "int8/im2col", "int8/matmul", "int8/dequantise")


def _profiled(fn):
    """Run ``fn`` (and wait for the card) under ``torch.profiler``: wall ms,
    the events, and the device's kernels and copies as (name, ms, count),
    heaviest first. A ``record_function`` range (the int8 stages,
    ``Optimizer.step#...``) also has a device row, which carries the time of
    the kernels launched inside it: a device row whose name is also a host
    row's is such a range and is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in events
                      if e.device_type == DeviceType.CUDA and e.key not in host),
                     key=lambda r: -r[1])
    return wall_ms, events, kernels


def _profile_step(phase: str, step, what: str = "step") -> float:
    """One step (or request) under ``torch.profiler``: wall time, device
    time of all kernels and copies (busy share), the share of each
    hand-written kernel, and the heaviest kernels by name. Returns the
    device time, ms; ``_profile_step.own`` keeps each hand-written kernel's
    (ms, launches) of the last profile."""
    wall_ms, events, kernels = _profiled(step)
    stages = sorted({e.key: e.device_time_total / 1e3 for e in events
                     if e.key in INT8_STAGES and e.device_time_total > 0}.items())
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        raise AssertionError(f"{phase} profile: no device time")
    own = {k: (sum(ms for name, ms, _ in kernels if frag in name),
               sum(n for name, _, n in kernels if frag in name))
           for k, frag in KERNEL_NAMES.items()}
    rest = busy_ms - sum(ms for ms, _ in own.values())
    _profile_step.own = own
    log(phase, f"profile of one {what}: wall {wall_ms:.3f} ms under the profiler, device kernels "
        f"and copies {busy_ms:.3f} ms in {sum(c for _, _, c in kernels)} launches (busy share "
        f"{busy_ms / wall_ms:.3f}); "
        + ", ".join(f"{k} {ms:.3f} ms ({ms / busy_ms:.1%}, {n}x)" for k, (ms, n) in own.items()
                    if n)
        + f", all else {rest:.3f} ms ({rest / busy_ms:.1%})"
        + ("; by int8 stage " + ", ".join(f"{name[5:]} {ms:.3f} ms ({ms / busy_ms:.1%})"
                                          for name, ms in stages) if stages else "")
        + "; by kind " + ", ".join(f"{kind} {ms:.3f} ms ({ms / busy_ms:.1%}, {n}x)"
                                   for kind, (ms, n) in _by_kind(kernels).items()))
    for name, ms, count in kernels[:8]:
        log(phase, f"  {ms:9.3f} ms {count:5d}x {name[:110]}")
    return busy_ms


# kernel-name fragments of the library's matrix products and convolutions
_GEMM_NAMES = ("gemm", "xmma", "nvjet", "cutlass", "sm90_", "sm80_", "cublas", "conv", "mm_")


def _by_kind(kernels) -> dict:
    """Device time and launches by kind of kernel: the hand-written ones
    (``KERNEL_NAMES``), the library's products and convolutions, copies,
    reductions, and elementwise passes (the rest)."""
    kinds = {}
    for name, ms, n in kernels:
        low = name.lower()
        if any(frag in name for frag in KERNEL_NAMES.values()):
            kind = "hand-written"
        elif any(frag in low for frag in _GEMM_NAMES):
            kind = "products"
        elif "memcpy" in low or "memset" in low or "copy" in low:
            kind = "copies and casts"
        elif "reduce" in low or "norm" in low or "softmax" in low:
            kind = "reductions"
        else:
            kind = "elementwise"
        t, c = kinds.get(kind, (0.0, 0))
        kinds[kind] = (t + ms, c + n)
    return dict(sorted(kinds.items(), key=lambda kv: -kv[1][0]))


def _finite(module) -> bool:
    return all(bool(torch.isfinite(p).all()) for p in module.parameters())


def _diffusion_state_dict(cfg):
    from lipreading_video_generation_tpu_torch.models.convert import (
        unet_audio_state_dict_from_flax)

    return unet_audio_state_dict_from_flax(flax_unet_audio_params(cfg, SEED), cfg)


def _grad_step(cfg, state_dict, batch, t, noise, device):
    """ε-MSE and the whole flattened gradient of one step of a fresh
    float32 train state on ``device``, at the given t and noise."""
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

    state = ttd.create_state(cfg, seed=SEED, device=device)
    state.model.load_state_dict(state_dict)
    prep = ttd.prepare_batch(batch, cfg, device)
    tt, nn_ = ttd.draw_t_noise(state, prep["target"], cfg.num_timesteps, t, noise)
    noisy = state.scheduler.add_noise(prep["target"], nn_, tt)
    loss = ttd.noise_mse(state.model(noisy, prep["cond"], prep["audio"], tt), nn_)
    loss.backward()
    return loss.item(), torch.cat([p.grad.flatten().double().cpu()
                                   for p in state.model.parameters()])


def train_runs(cfg, sd, batches, step, fault=None) -> dict:
    """``step`` (``train_step`` or ``eager_step``) over ``batches`` from one
    seeded state holding ``sd``; ``fault`` (a stand-in for ``apply_update``)
    is planted in the module for the run. → each step's loss, route, and
    whether a replayed step drew the t and noise an eager step would from
    the generator's state (equal bits); the final params, EMA, Adam moments
    and generator state, and the state."""
    from lipreading_video_generation_tpu_torch.core.prng import uniform_timesteps
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

    state = ttd.create_state(cfg, seed=SEED, device="cuda")
    state.model.load_state_dict(sd)
    state.ema.load_state_dict(sd)
    planted, out = ttd.apply_update, {"loss": [], "routes": [], "draws": []}
    if fault is not None:
        ttd.apply_update = fault
    try:
        for batch in batches:
            gen = torch.Generator("cuda")
            gen.set_state(state.generator.get_state())
            n, s = len(batch["audio"]), cfg.im_size
            want = (uniform_timesteps(gen, n, cfg.num_timesteps),
                    torch.randn((n, cfg.im_channels, s, s), generator=gen, device="cuda"))
            before = dict(ttd.train_step.route_counts)
            out["loss"].append(step(state, batch, cfg)["loss"].item())
            out["routes"].append(next((r for r in ("capture", "graph", "eager")
                                       if ttd.train_step.route_counts[r] != before[r]), None))
            if out["routes"][-1] in ("capture", "graph"):
                got = state.graph.outputs
                out["draws"].append(torch.equal(got["t"], want[0])
                                    and torch.equal(got["noise"], want[1]))
    finally:
        ttd.apply_update = planted
    opt = state.optimizer
    out["tensors"] = {**{f"param {k}": p.detach().clone() for k, p in state.model.named_parameters()},
                      **{f"ema {k}": p.detach().clone() for k, p in state.ema.named_parameters()}}
    for k, p in state.model.named_parameters():
        for m in ("exp_avg", "exp_avg_sq"):
            if p in opt.state:
                out["tensors"][f"{m} {k}"] = opt.state[p][m].clone()
    out["generator"] = state.generator.get_state()
    out["state"] = state
    return out


def compare_train_runs(a: dict, b: dict, g: dict) -> dict:
    """Graphed run ``g`` against eager run ``a``, with eager run ``b`` as
    eager's own spread: the losses, and each of the params, EMA and Adam
    moments, equal to the bit where ``a`` and ``b`` are equal; where they
    are not, ``g`` no farther from ``a`` than ``b`` is (the L2 over those
    tensors, within 2x: one graphed run is one draw of the same
    nondeterminism). → counts for the log."""
    if set(g["tensors"]) != set(a["tensors"]):
        raise AssertionError("the graphed run holds other tensors than the eager one")
    same = [k for k in a["tensors"] if torch.equal(a["tensors"][k], b["tensors"][k])]
    off = [k for k in same if not torch.equal(g["tensors"][k], a["tensors"][k])]
    if off:
        raise AssertionError(f"graphed and eager differ in {len(off)} tensors that two eager runs "
                             f"give equal, e.g. {off[:3]}")
    if (g["loss"] != a["loss"]) and (a["loss"] == b["loss"]):
        raise AssertionError(f"losses graphed {g['loss']} eager {a['loss']}")
    rest = [k for k in a["tensors"] if k not in same]
    dist = lambda x, keys: sum(float((x["tensors"][k].double() - a["tensors"][k].double())
                                     .norm()) ** 2 for k in keys) ** 0.5
    d_g, d_b = dist(g, rest), dist(b, rest)
    if d_g > 2 * d_b:
        raise AssertionError(f"graphed run {d_g:.3g} from eager, eager {d_b:.3g} from itself, "
                             f"over {len(rest)} tensors")
    return {"tensors": len(a["tensors"]), "eager_equal": len(same), "graph_l2": d_g,
            "eager_l2": d_b}


def check_train_graph(cfg, sd, batches) -> None:
    """[train-graph]: graphed ``train_step``s over ``batches`` (3 or more)
    against as many ``eager_step``s from one seed (two eager runs for
    eager's own spread), then the graphed run with a planted
    ``state_unchanged`` fault (``benchmarks/faults.py``'s: the step
    counted, the state left as it was), which the capture must hold."""
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

    n = len(batches)
    runs = {}
    for name, step in (("eager", ttd.eager_step), ("eager again", ttd.eager_step),
                       ("graphed", ttd.train_step)):
        run = train_runs(cfg, sd, batches, step)
        del run["state"]
        runs[name] = run
        torch.cuda.empty_cache()
    a, b, g = runs["eager"], runs["eager again"], runs["graphed"]
    want = ["eager", "capture"] + ["graph"] * (n - 2)
    if g["routes"] != want or not all(g["draws"]) or len(g["draws"]) != n - 1:
        raise AssertionError(f"graphed run: routes {g['routes']}, draws equal {g['draws']}")
    if not torch.equal(g["generator"], a["generator"]):
        raise AssertionError("the graphed run left the generator elsewhere than eager steps")
    c = compare_train_runs(a, b, g)

    def state_unchanged(state, loss):
        state.step += 1

    f = train_runs(cfg, sd, batches, ttd.train_step, fault=state_unchanged)
    moved = [k for k, p in f["state"].model.state_dict().items()
             if not torch.equal(p.cpu(), sd[k].to(p.dtype))]
    if f["routes"] != want or moved or f["state"].step != n:
        raise AssertionError(f"planted state_unchanged: routes {f['routes']}, moved {moved[:3]}, "
                             f"step {f['state'].step}")
    del f
    torch.cuda.empty_cache()
    log("train-graph", f"{n} steps at batch {len(batches[0]['audio'])}, routes {g['routes']}: "
        f"t and noise of the {len(g['draws'])} graphed steps equal to an eager step's draws "
        f"from the same generator state, the generator left where eager leaves it; losses "
        f"graphed {g['loss']} eager {a['loss']} again {b['loss']}; of {c['tensors']} params, "
        f"EMA and moments {c['eager_equal']} equal in two eager runs, and equal graphed; the "
        f"rest L2 graphed-eager {c['graph_l2']:.3g}, eager-eager {c['eager_l2']:.3g}; a planted "
        f"state_unchanged was captured (params as loaded after {n} steps)")


def phase_train(dev: dict) -> dict:
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

    cfg = DiffusionConfig()
    sd = _diffusion_state_dict(cfg)
    state = ttd.create_state(cfg, seed=SEED, device="cuda")
    state.model.load_state_dict(sd)
    state.ema.load_state_dict(sd)
    n_params = sum(p.numel() for p in state.model.parameters())
    log("train", f"DiffusionConfig defaults, batch {TRAIN_BATCH}, dropout {cfg.dropout}, "
        f"lr {cfg.learning_rate}, Adam (0.9, 0.999, 1e-8), EMA {state.ema_rate}; {n_params} "
        "float32 params from seeded numpy via unet_audio_state_dict_from_flax")
    per_step = {"small_mha": 4, "flash_attention": 16, "flash_bwd_dkv": 16, "flash_bwd_dq": 16}
    _zero_counts()
    ttd.train_step(state, train_batch(cfg, TRAIN_BATCH, SEED + 2), cfg)   # warm-up: eager
    torch.cuda.synchronize()
    if _counts() != per_step:
        raise AssertionError(f"the eager warm-up step launched {_counts()}, want {per_step}")
    ema0 = [e.detach().clone() for e in state.ema.parameters()]
    torch.cuda.reset_peak_memory_stats()
    times, losses, took = [], [], dict.fromkeys(ttd.ROUTES, 0)
    for i in range(5):
        batch = train_batch(cfg, TRAIN_BATCH, SEED + 3 + i)
        before, before_r = _counts(), _train_routes()
        t0 = time.perf_counter()
        losses.append(ttd.train_step(state, batch, cfg)["loss"].item())
        times.append(time.perf_counter() - t0)
        routes = {k: n - before_r[k] for k, n in _train_routes().items()}
        d = _delta(before)
        if any(d.values()) or routes["eager"] + routes["graph"] != 1:
            raise AssertionError(f"a graphed step by the routes {routes} counted {d} through "
                                 "the wrappers, want none")
        took = {k: took[k] + n for k, n in routes.items()}
    if took != {"eager": 0, "capture": 1, "graph": 5}:
        raise AssertionError(f"5 steps after the warm-up took the routes {took}, want a "
                             "capture and 5 replays")
    _all_by_tensor_cores("train", att.flash_attention, att.flash_bwd_dkv, att.flash_bwd_dq,
                         att.small_mha)
    # two more replays under a device trace: their launches by name
    before, before_r = _counts(), _train_routes()
    _, traced = _traced_launches(lambda: [ttd.train_step(
        state, train_batch(cfg, TRAIN_BATCH, SEED + 20 + i), cfg)["loss"].item()
        for i in range(2)])
    replays = _train_routes()["graph"] - before_r["graph"]
    if replays != 2 or traced != _with_replays(_delta(before), per_step, replays):
        raise AssertionError(f"{replays} replays under a device trace: the trace holds "
                             f"{traced}, want {per_step} a replay by the tensor-core kernels")
    launches = {k: _counts()[k] + traced[k] for k in traced}
    peak = torch.cuda.max_memory_allocated()
    ema_moved = sum(int(not torch.equal(e, e0)) for e, e0 in zip(state.ema.parameters(), ema0))
    if not (np.isfinite(losses).all() and _finite(state.model) and _finite(state.ema)):
        raise AssertionError(f"non-finite loss, params or EMA: losses {losses}")
    if ema_moved == 0:
        raise AssertionError("the EMA did not move in 5 steps")
    log("train", f"5 steps (routes {took}): losses {[round(x, 5) for x in losses]}; launches "
        f"per step K2 4 K3 16 K4 16 K5 16, all by the tensor-core route: the eager warm-up's "
        f"counted by the wrappers, which counted none in the 5 graphed steps, and 2 more "
        f"replays' by name in a device trace {traced}; params and EMA finite; EMA moved in "
        f"{ema_moved}/{len(ema0)} tensors")

    busy_ms = _profile_step("train", lambda: ttd.train_step(
        state, train_batch(cfg, TRAIN_BATCH, SEED + 8), cfg)["loss"].item(), "replayed step")
    if _profile_step.own["K4"][1] != 16 or _profile_step.own["K5"][1] != 16:
        raise AssertionError(f"the replayed step's trace holds K4/K5 {_profile_step.own}, want "
                             "16 launches each by name")
    # a FLOP count sees the ops as they are dispatched, which a replay does
    # not do: the counted step runs eager (t and noise given)
    rng = np.random.default_rng(SEED + 13)
    t = rng.integers(0, cfg.num_timesteps, TRAIN_BATCH)
    noise = rng.standard_normal((TRAIN_BATCH, cfg.im_size, cfg.im_size, 3)).astype(np.float32)
    count_flops("train", f"a batch-{TRAIN_BATCH} bf16 diffusion training step at the defaults",
                statistics.median(times), per_step,
                lambda: ttd.train_step(state, train_batch(cfg, TRAIN_BATCH, SEED + 8),
                                       cfg, t, noise)["loss"].item())

    # 10 steps on one batch at fixed t and noise: the loss must fall
    rng = np.random.default_rng(SEED + 9)
    batch = train_batch(cfg, TRAIN_BATCH, SEED + 10)
    t = rng.integers(0, cfg.num_timesteps, TRAIN_BATCH)
    noise = rng.standard_normal((TRAIN_BATCH, cfg.im_size, cfg.im_size, 3)).astype(np.float32)
    fixed = [ttd.train_step(state, batch, cfg, t, noise)["loss"].item() for _ in range(10)]
    log("train", f"10 steps on one batch, fixed t and noise: losses "
        f"{[round(x, 5) for x in fixed]}")
    if not fixed[-1] < fixed[0]:
        raise AssertionError(f"loss did not fall on a fixed batch: {fixed}")
    del state
    check_train_graph(cfg, sd, [train_batch(cfg, TRAIN_BATCH, SEED + 60 + i) for i in range(4)])

    # one float32 step, card against the CPU plain path: full channel plan,
    # 64x64 (frames already at 64x64: no resize to round differently), batch 2
    cfg32 = dataclasses.replace(cfg, im_size=64, dtype="float32", dropout=0.0)
    batch = train_batch(cfg32, 2, SEED + 11, size=64)
    t = np.array([17, 402])
    noise = np.random.default_rng(SEED + 12).standard_normal((2, 64, 64, 3)).astype(np.float32)
    # its K3/K4/K5 launches by the tiled kernels of csrc/flash_fwd.cu and flash_bwd.cu
    l_gpu, g_gpu = _tiled_run("train", "float32 step at 64x64",
                              lambda: _grad_step(cfg32, sd, batch, t, noise, "cuda"))
    l_cpu, g_cpu = _grad_step(cfg32, sd, batch, t, noise, "cpu")
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = ((g_gpu - g_cpu).norm() / g_cpu.norm()).item()
    log("train", f"float32 step at 64x64, batch 2, card vs CPU plain path: loss {l_gpu:.7g} vs "
        f"{l_cpu:.7g} (rel {loss_rel:.3g}, tol {TOL_TRAIN_LOSS}); whole gradient rel L2 "
        f"{grad_rel:.3g} (tol {TOL_TRAIN_GRAD}); tf32 off")
    if not (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD):
        raise AssertionError(f"float32 step card vs CPU: loss rel {loss_rel}, grad rel {grad_rel}")

    step_s = statistics.median(times)
    log("train", f"step times ({dev['smi']}): {[round(x * 1e3, 3) for x in times]} ms; median "
        f"{step_s * 1e3:.3f} ms = {TRAIN_BATCH / step_s:.2f} trained frames/s (the profiled "
        f"step's {busy_ms:.3f} ms of kernels are {busy_ms / (step_s * 1e3):.3f} of it); peak "
        f"device memory {peak / 2**20:.1f} MiB")
    return {"launches": launches, "step_ms": step_s * 1e3, "peak_mib": peak / 2**20}


def phase_superres(dev: dict) -> dict:
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig, SuperResConfig
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.pipelines import train_superres as tsr
    from lipreading_video_generation_tpu_torch.pipelines.sample_diffusion import sample_cascade

    scfg = SuperResConfig()
    state = tsr.create_state(scfg, seed=SEED, device="cuda")
    n_attn = sum(type(m).__name__ == "AttentionBlock" for m in state.model.modules())
    log("superres", f"SuperResConfig defaults: {scfg.low_size}->{scfg.im_size}, base "
        f"{scfg.base_channels}, channel_mult {scfg.channel_mult}, {scfg.num_res_blocks} res "
        f"blocks, attention at ds {scfg.attention_resolutions} ({n_attn} AttentionBlocks, "
        f"{(scfg.im_size // 4) ** 2} tokens, d={scfg.base_channels * 4}), {scfg.dtype}; "
        f"{sum(p.numel() for p in state.model.parameters())} params (seeded Flax-style init)")
    _zero_counts()
    losses, times = [], []
    for i in range(3):
        batch = {"target_frame": np.random.default_rng(SEED + 40 + i).integers(
            0, 256, (TRAIN_BATCH, 160, 160, 3), dtype=np.uint8)}
        before = _counts()
        t0 = time.perf_counter()
        losses.append(tsr.train_step(state, batch, scfg)["loss"].item())
        times.append(time.perf_counter() - t0)
        d = _delta(before)
        want = {"small_mha": 0, "flash_attention": n_attn, "flash_bwd_dkv": n_attn,
                "flash_bwd_dq": n_attn}
        if d != want:
            raise AssertionError(f"SR train step launched {d}, want {want}")
    if not (np.isfinite(losses).all() and _finite(state.model)):
        raise AssertionError(f"SR training: non-finite loss or params ({losses})")
    _all_by_tensor_cores("superres", att.flash_attention, att.flash_bwd_dkv, att.flash_bwd_dq)
    log("superres", f"3 train steps at batch {TRAIN_BATCH}: losses "
        f"{[round(x, 5) for x in losses]}, times {[round(x * 1e3, 3) for x in times]} ms "
        f"({dev['smi']}); K3/K4/K5 {n_attn} each a step, all by the tensor-core route")

    base_cfg = dataclasses.replace(DiffusionConfig(), im_size=scfg.low_size)
    base = _load_unet_audio(base_cfg, _diffusion_state_dict(base_cfg), "cuda")
    frame, audio = diffusion_inputs(base_cfg, DIFF_FRAMES, SEED)
    cond = torch.as_tensor(frame)[None].expand((DIFF_FRAMES,) + frame.shape)
    sr_model = state.ema.eval()
    before = _counts()
    t0 = time.perf_counter()
    high, low = sample_cascade(base, cond, audio, base_cfg, sr_model, scfg,
                               num_inference_steps=DIFF_STEPS,
                               generator=torch.Generator("cuda").manual_seed(SEED))
    high = high.cpu()
    cascade_s = time.perf_counter() - t0
    d = _delta(before)
    want_k3 = 16 * DIFF_STEPS + n_attn * scfg.sr_inference_steps
    if tuple(high.shape) != (DIFF_FRAMES, 128, 128, 3) or tuple(low.shape) != (
            DIFF_FRAMES, 64, 64, 3) or not bool(torch.isfinite(high).all()):
        raise AssertionError(f"cascade gave {tuple(high.shape)} / {tuple(low.shape)}")
    if d["flash_attention"] != want_k3:
        raise AssertionError(f"cascade launched {d}, want K3 {want_k3}")
    _all_by_tensor_cores("superres", att.flash_attention)
    log("superres", f"sample_cascade: base 64x64 {DIFF_FRAMES} frames x {DIFF_STEPS} DDIM "
        f"steps, SR {scfg.sr_inference_steps} DDIM steps -> {tuple(high.shape)} in "
        f"[{high.min().item():.3f}, {high.max().item():.3f}], finite; K3 launches "
        f"{d['flash_attention']}, routes since the first train step "
        f"{att.flash_attention.route_counts}; {cascade_s * 1e3:.3f} ms ({dev['smi']})")
    return {"launches": _counts()}


def phase_guidance(dev: dict) -> dict:
    from lipreading_video_generation_tpu_torch.core.config import (
        ClassifierConfig, DiffusionConfig)
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.pipelines import train_classifier as ttc
    from lipreading_video_generation_tpu_torch.pipelines.sample_diffusion import sample_video

    ccfg, dcfg = ClassifierConfig(), DiffusionConfig()
    state = ttc.create_state(ccfg, dcfg, seed=SEED, device="cuda")
    n_attn = sum(type(m).__name__ == "AttentionBlock" for m in state.model.modules())
    log("guidance", f"ClassifierConfig defaults: {ccfg.num_classes} classes, base "
        f"{ccfg.base_channels}, channel_mult {ccfg.channel_mult}, attention at ds "
        f"{ccfg.attention_resolutions} ({n_attn} AttentionBlocks, {ccfg.num_heads} heads), "
        f"{ccfg.dtype}, {dcfg.im_size}x{dcfg.im_size}, batch {ccfg.batch_size}")
    _zero_counts()
    rng = np.random.default_rng(SEED + 50)
    metrics = []
    for _ in range(5):
        before = _counts()
        m = ttc.train_step(state, ttc.synthetic_batch(rng, ccfg, dcfg), ccfg, dcfg)
        metrics.append((round(m["loss"].item(), 5), round(m["accuracy"].item(), 4)))
        d = _delta(before)
        want = {"small_mha": 0, "flash_attention": n_attn, "flash_bwd_dkv": n_attn,
                "flash_bwd_dq": n_attn}
        if d != want:
            raise AssertionError(f"classifier train step launched {d}, want {want}")
    if not (np.isfinite([x for x, _ in metrics]).all() and _finite(state.model)):
        raise AssertionError(f"classifier training: non-finite loss or params ({metrics})")
    log("guidance", f"5 train steps (loss, accuracy): {metrics}")

    model = _load_unet_audio(dcfg, _diffusion_state_dict(dcfg), "cuda")
    frame, audio = diffusion_inputs(dcfg, DIFF_FRAMES, SEED)
    gen = torch.Generator("cuda")
    plain = sample_video(model, frame, audio, dcfg, num_inference_steps=DIFF_STEPS,
                         generator=gen.manual_seed(SEED)).cpu()
    before = _counts()
    t0 = time.perf_counter()
    guided = sample_video(model, frame, audio, dcfg, num_inference_steps=DIFF_STEPS,
                          classifier_cfg=ccfg, classifier_params=state.model.state_dict(),
                          class_label=2, guidance_scale=5.0,
                          generator=gen.manual_seed(SEED)).cpu()
    guided_s = time.perf_counter() - t0
    d = _delta(before)
    want = {"small_mha": 4, "flash_attention": (16 + n_attn) * DIFF_STEPS,
            "flash_bwd_dkv": n_attn * DIFF_STEPS, "flash_bwd_dq": n_attn * DIFF_STEPS}
    if d != want:
        raise AssertionError(f"guided request launched {d}, want {want}")
    if guided.dtype != torch.uint8 or tuple(guided.shape) != (DIFF_FRAMES, 128, 128, 3):
        raise AssertionError(f"bad guided frames {guided.dtype} {tuple(guided.shape)}")
    moved = (guided.int() - plain.int()).abs().float().mean().item()
    if moved == 0:
        raise AssertionError("guidance changed nothing")
    _all_by_tensor_cores("guidance", att.flash_attention, att.flash_bwd_dkv, att.flash_bwd_dq,
                         att.small_mha)
    log("guidance", f"guided sample_video (label 2, scale 5), {DIFF_FRAMES} frames x "
        f"{DIFF_STEPS} DDIM steps: launches {d} ({n_attn} K4/K5 a step; K3, K4 and K5 all by "
        f"the tensor-core route since the first classifier step); mean |guided - "
        f"unguided| {moved:.3f} levels; {guided_s * 1e3:.3f} ms ({dev['smi']})")
    return {"launches": _counts()}


DATA_VIDEOS = 4              # in-memory videos of the frame index
DATA_VIDEO_FRAMES = 48       # 160x160 frames each, at 25 fps
DATA_RECORDS = 64            # diffusion records packed at 128x128
DATA_TRAIN_STEPS = 12
DATA_GAN_RECORDS = 32
DATA_GAN_STEPS = 8


@contextlib.contextmanager
def _timed(module, name: str, times: list, after=None):
    """Wrap ``module.name`` for the block: each call's wall seconds (after
    ``after(result)``, e.g. a synchronise) are appended to ``times``. The
    wrapper carries the function's attributes (``train_step.route_counts``)."""
    orig = getattr(module, name)

    @functools.wraps(orig)
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        if after is not None:
            after(out)
        times.append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG of unfiltered rows (as ``data/video.write_png``
    writes them) → (H, W, 3) uint8, decoded with ``zlib`` alone."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if (depth, color) != (8, 2):
                raise AssertionError(f"{path}: bit depth {depth}, colour type {color}")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: filtered rows")
    return rows[:, 1:].reshape(h, w, 3).copy()


def phase_data(dev: dict) -> dict:
    """The data feed at the ``DiffusionConfig`` and ``GanConfig`` defaults:
    the native loader's build, a frame index of in-memory videos through the
    seams, packed diffusion records, ``train-diffusion --records-root`` (4
    steps a dispatch), ``sample-diffusion --checkpoint`` on what it saved,
    ``pack-gan-records`` and ``train-gan --records-root``."""
    import os
    import tempfile

    from lipreading_video_generation_tpu_torch import cli
    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig, GanConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.data import datasets as tdata
    from lipreading_video_generation_tpu_torch.data import native_loader as nl
    from lipreading_video_generation_tpu_torch.data import records as trec
    from lipreading_video_generation_tpu_torch.data import video as tvideo
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.pipelines import sample_diffusion as tsd
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    phase_t0 = time.perf_counter()
    lib = nl.build(force=True)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(tdata.__file__)))
    if not str(lib).startswith(pkg + os.sep) or not nl.native_available():
        raise AssertionError(f"prefetch loader built at {lib}, not under {pkg}")
    log("data", f"prefetch loader built by {nl.build_info['compiler']} in "
        f"{nl.build_info['seconds']:.2f} s: {lib}")
    cfg, gcfg = DiffusionConfig(), GanConfig()
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_data_")
    root = work.name
    try:
        # frame index of in-memory videos: frames through the seams, sidecar waves on disk
        clips = tdata.synthetic_av_clips(n_clips=DATA_VIDEOS, frames=DATA_VIDEO_FRAMES, img=160,
                                         seed=SEED + 60)
        os.makedirs(os.path.join(root, "videos"))
        videos = {}
        for i, clip in enumerate(clips):
            path = os.path.join(root, "videos", f"{i:05d}.mp4")   # never opened
            tvideo.save_wav(os.path.splitext(path)[0] + ".wav", clip.wav)
            videos[path] = (clip.frames, 25.0)
        t0 = time.perf_counter()
        items = tdata.build_frame_index(sorted(videos), step=6,
                                        frame_count=lambda p: len(videos[p][0]))
        sampler = tdata.DiffusionPairSampler(items, cfg.audio_samples, cfg.buffer_frames,
                                             seed=SEED, read_frames=videos.__getitem__)
        recs = os.path.join(root, "diffusion_records")
        spec = trec.write_diffusion_records(sampler, recs, DATA_RECORDS, cfg.im_size)
        pack_s = time.perf_counter() - t0
        want_bytes = 2 * cfg.im_size * cfg.im_size * 3 + 4 * cfg.audio_samples   # 114,304
        if spec.record_bytes != want_bytes or len(trec.record_paths(recs)) != DATA_RECORDS:
            raise AssertionError(f"records of {spec.record_bytes} B, "
                                 f"{len(trec.record_paths(recs))} files")
        log("data", f"frame index: {len(items)} pairs of {DATA_VIDEOS} in-memory videos "
            f"({DATA_VIDEO_FRAMES} frames of 160x160 at 25 fps, sidecar waves); "
            f"{DATA_RECORDS} diffusion records of {spec.record_bytes} B at {cfg.im_size}x"
            f"{cfg.im_size} in {pack_s:.3f} s = {DATA_RECORDS / pack_s:.1f} records/s "
            "(DiffusionPairSampler, resize on the host)")

        # train-diffusion from the records, 4 steps a dispatch, one checkpoint
        ck = os.path.join(root, "diffusion_ck")
        steps, losses, waits, saves = [], [], [], []
        native0 = dict(trec.iter_record_batches.route_counts)
        _zero_counts()

        def synced_loss(out):
            losses.append(out["loss"].item())      # the trainer reads it next anyway

        t0 = time.perf_counter()
        before_r = _train_routes()
        with _timed(ttd, "train_step", steps, synced_loss), _timed(ttd, "take", waits), \
                _timed(ttd, "save_checkpoint", saves):
            rc, traced = _traced_launches(lambda: cli.main(
                ["train-diffusion", "--records-root", recs, "--steps", str(DATA_TRAIN_STEPS),
                 "--steps-per-dispatch", "4", "--checkpoint-dir", ck, "--checkpoint-every",
                 str(DATA_TRAIN_STEPS)]))
        train_s = time.perf_counter() - t0
        took = {k: n - before_r[k] for k, n in _train_routes().items()}
        d = _counts()
        # the wrappers: the eager first step and the eval at the last step (K2
        # 4, K3 16); the trace: those and each replay's
        per_step = {"small_mha": 4, "flash_attention": 16, "flash_bwd_dkv": 16, "flash_bwd_dq": 16}
        want = dict(per_step, small_mha=4 + 4, flash_attention=16 + 16)
        routes = dict(trec.iter_record_batches.route_counts)
        if (rc != 0 or len(steps) != DATA_TRAIN_STEPS or d != want
                or took != {"eager": 1, "capture": 1, "graph": DATA_TRAIN_STEPS - 1}
                or traced != _with_replays(d, per_step, took["graph"])):
            raise AssertionError(f"train-diffusion: rc {rc}, {len(steps)} steps by the routes "
                                 f"{took}, the wrappers counted {d} (want {want}), the device "
                                 f"trace holds {traced}")
        if routes["native"] != native0["native"] + 1 or routes["plain"] != native0["plain"]:
            raise AssertionError(f"the records fed train-diffusion by the routes {routes}")
        if not (np.isfinite(losses).all() and len(saves) == 1):
            raise AssertionError(f"losses {losses}, {len(saves)} checkpoints")
        _all_by_tensor_cores("data", att.small_mha, att.flash_attention, att.flash_bwd_dkv,
                             att.flash_bwd_dq)
        launches = dict(traced)
        ck_path = ttd.latest_checkpoint(ck)
        ck_mb = os.path.getsize(ck_path) / 2**20
        step_ms = [x * 1e3 for x in steps]
        loop_s = sum(steps) + sum(waits)
        log("data", f"train-diffusion --records-root --steps {DATA_TRAIN_STEPS} "
            f"--steps-per-dispatch 4 at the DiffusionConfig defaults (batch {cfg.batch_size}, "
            f"{cfg.dtype}), native route ({routes}): {train_s:.2f} s in cli.main; step 0 "
            f"{step_ms[0]:.1f} ms, steps 1-{DATA_TRAIN_STEPS - 1} median "
            f"{statistics.median(step_ms[1:]):.3f} ms (min {min(step_ms[1:]):.3f}, max "
            f"{max(step_ms[1:]):.3f}) ({dev['smi']}); feed waits {len(waits)} takes, "
            f"{sum(waits) * 1e3:.3f} ms = {sum(waits) / loop_s:.4f} of the loop (first take "
            f"{waits[0] * 1e3:.3f} ms; the rest {sum(waits[1:]) * 1e3:.3f} ms = "
            f"{sum(waits[1:]) / (loop_s - waits[0] - steps[0]):.4f} of steps 1-"
            f"{DATA_TRAIN_STEPS - 1}); loss step 0 {losses[0]:.5f}, step "
            f"{DATA_TRAIN_STEPS - 1} {losses[-1]:.5f}; checkpoint {ck_mb:.1f} MiB written in "
            f"{saves[0]:.3f} s (the run under a device trace); steps by the routes {took}; "
            f"launches by name in the trace {launches}, through the wrappers {d} (4 K2, 16 "
            f"K3/K4/K5 a step, the eval at step {DATA_TRAIN_STEPS} K2 4 and K3 16; all by sm90)")

        # sample-diffusion from that checkpoint, held against sample_video on its EMA
        out = os.path.join(root, "sample")
        loads, samples, writes = [], [], []
        before = _counts()
        t0 = time.perf_counter()
        with _timed(ttd, "load_sampling_params", loads), \
                _timed(tsd, "sample_video", samples, lambda x: torch.cuda.synchronize()), \
                _timed(tvideo, "write_png", writes):
            rc = cli.main(["sample-diffusion", "--checkpoint", ck, "--frames", str(DIFF_FRAMES),
                           "--ddim-steps", str(DIFF_STEPS), "--out", out])
        request_s = time.perf_counter() - t0
        d = _delta(before)
        want = {"small_mha": 4, "flash_attention": 16 * DIFF_STEPS, "flash_bwd_dkv": 0,
                "flash_bwd_dq": 0}
        if rc != 0 or d != want:
            raise AssertionError(f"sample-diffusion: rc {rc}, launches {d}, want {want}")
        for k, v in d.items():
            launches[k] += v
        _all_by_tensor_cores("data", att.small_mha, att.flash_attention)
        frames = np.stack([read_png(f"{out}.{j:04d}.png") for j in range(DIFF_FRAMES)])
        if frames.shape != (DIFF_FRAMES, cfg.im_size, cfg.im_size, 3) or not all(
                f.std() > 0 for f in frames):
            raise AssertionError(f"sample-diffusion PNGs {frames.shape}, stds "
                                 f"{[float(f.std()) for f in frames]}")
        model = seeded(lambda: UNetAudio(cfg), SEED)
        model.load_state_dict(ttd.load_sampling_params(ck))
        model = model.to("cuda").eval()
        rng = np.random.default_rng(SEED)        # the CLI's draws without --cond-video
        cond = rng.integers(0, 256, (cfg.im_size, cfg.im_size, 3), dtype=np.uint8)
        windows = rng.standard_normal((DIFF_FRAMES, cfg.audio_samples)).astype(np.float32)
        direct = tsd.sample_video(model, cond, windows, cfg, num_inference_steps=DIFF_STEPS,
                                  generator=torch.Generator("cuda").manual_seed(SEED)).cpu()
        diff = int(np.abs(direct.numpy().astype(int) - frames.astype(int)).max())
        if diff > 1:
            raise AssertionError(f"sample-diffusion PNGs differ from sample_video by {diff} levels")
        del model
        log("data", f"sample-diffusion --checkpoint --frames {DIFF_FRAMES} --ddim-steps "
            f"{DIFF_STEPS}: {request_s:.3f} s in cli.main: load "
            f"{request_s - samples[0] - sum(writes):.3f} s (seeded init, torch.load of the "
            f"checkpoint's EMA {loads[0]:.3f} s, copy to the card), sample {samples[0] * 1e3:.3f} ms, write {len(writes)} PNGs "
            f"{sum(writes) * 1e3:.3f} ms ({dev['smi']}); PNGs read back with zlib: "
            f"{frames.shape} uint8, pixel means {[round(float(f.mean()), 2) for f in frames]}, "
            f"max {diff} levels from sample_video on the same EMA params and seed; launches {d} "
            f"(all by sm90)")

        # pack-gan-records, then train-gan from them in one dispatch of 8 steps
        grecs = os.path.join(root, "gan_records")
        t0 = time.perf_counter()
        rc = cli.main(["pack-gan-records", "--synthetic", "--out", grecs, "--num-records",
                       str(DATA_GAN_RECORDS)])
        gpack_s = time.perf_counter() - t0
        gspec = trec.load_spec(grecs)
        if rc != 0 or len(trec.record_paths(grecs)) != DATA_GAN_RECORDS:
            raise AssertionError(f"pack-gan-records: rc {rc}")
        gsteps, gmetrics, gwaits = [], [], []
        native0 = dict(trec.iter_record_batches.route_counts)
        before = _counts()

        def gan_metrics(out):
            gmetrics.append({k: round(float(v), 5) for k, v in out.items()
                             if k in ("loss/g_total", "loss/l1", "loss/d_real", "loss/d_fake")})

        t0 = time.perf_counter()
        with _timed(ttg, "train_step", gsteps, gan_metrics), _timed(ttg, "take", gwaits):
            rc = cli.main(["train-gan", "--records-root", grecs, "--steps", str(DATA_GAN_STEPS),
                           "--steps-per-dispatch", str(DATA_GAN_STEPS)])
        gtrain_s = time.perf_counter() - t0
        routes = dict(trec.iter_record_batches.route_counts)
        if rc != 0 or len(gsteps) != DATA_GAN_STEPS or _delta(before) != dict.fromkeys(before, 0):
            raise AssertionError(f"train-gan: rc {rc}, {len(gsteps)} steps, launches "
                                 f"{_delta(before)}")
        if routes["native"] != native0["native"] + 1 or routes["plain"] != native0["plain"]:
            raise AssertionError(f"the records fed train-gan by the routes {routes}")
        if not all(np.isfinite(list(m.values())).all() for m in gmetrics):
            raise AssertionError(f"train-gan losses {gmetrics}")
        gms = [x * 1e3 for x in gsteps]
        log("data", f"pack-gan-records --synthetic: {DATA_GAN_RECORDS} records of "
            f"{gspec.record_bytes} B in {gpack_s:.3f} s; train-gan --records-root --steps "
            f"{DATA_GAN_STEPS} --steps-per-dispatch {DATA_GAN_STEPS} at the GanConfig defaults "
            f"(width {gcfg.model_width}, batch {gcfg.batch_size}, {gcfg.dtype}), native route: "
            f"{gtrain_s:.2f} s in cli.main; step 0 {gms[0]:.1f} ms, steps 1-"
            f"{DATA_GAN_STEPS - 1} median {statistics.median(gms[1:]):.3f} ms ({dev['smi']}); "
            f"feed waits {len(gwaits)} takes, {sum(gwaits) * 1e3:.3f} ms = "
            f"{sum(gwaits) / (sum(gsteps) + sum(gwaits)):.4f} of the loop; losses step 0 "
            f"{gmetrics[0]}, step {DATA_GAN_STEPS - 1} {gmetrics[-1]}; no hand-written kernel "
            "(as in [gan])")
    finally:
        work.cleanup()
    log("data", f"phase took {time.perf_counter() - phase_t0:.1f} s")
    return {"launches": launches}


def flax_generator_params(width: float, seed: int) -> dict:
    """Random weights in the tree and shapes of the Flax
    ``TalkingFaceGenerator(width=width)`` (the card's machine has no flax):
    conv kernels (kh, kw, in, out) ~ N(0, 1/fan_in), small biases, GroupNorm
    scales near 1. The shapes come from the port's own module, the tree from
    the bridge's map of Flax module paths."""
    from lipreading_video_generation_tpu_torch.models.convert import generator_flax_module_names
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator

    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {name: tuple(m.weight.shape) for name, m in
                  TalkingFaceGenerator(width=width).named_modules() if hasattr(m, "weight")}
    params: dict = {}
    for flax_path, name in generator_flax_module_names().items():
        *parents, leaf = flax_path.split("/")
        node = params
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = _flax_conv(rng, shapes[name])
        if leaf == "Conv_0" and parents[-1].startswith("ConvBlock"):
            node["GroupNorm_0"] = _flax_norm(rng, shapes[name][0])
    return params


def _flax_conv(rng, shape) -> dict:
    """A Flax ``Conv`` for a port conv weight of ``shape`` (out, in, kh, kw):
    HWIO kernel ~ N(0, 1/fan_in), small bias."""
    c_out, c_in, kh, kw = shape
    return {"kernel": (rng.standard_normal((kh, kw, c_in, c_out))
                       / math.sqrt(kh * kw * c_in)).astype(np.float32),
            "bias": (0.02 * rng.standard_normal(c_out)).astype(np.float32)}


def _flax_norm(rng, channels: int) -> dict:
    """A Flax ``GroupNorm``: scales near 1, small biases."""
    return {"scale": (1 + 0.05 * rng.standard_normal(channels)).astype(np.float32),
            "bias": (0.05 * rng.standard_normal(channels)).astype(np.float32)}


def lipsync_inputs(n: int, seed: int):
    """scripts/bench_lipsync_serving.py's inputs: random 360×640 RGB uint8
    frames, face boxes [40, 300, 180, 430] ± 4, standard-normal mel windows."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n,) + LIPSYNC_HW + (3,), dtype=np.uint8)
    boxes = (np.tile([40.0, 300.0, 180.0, 430.0], (n, 1)).astype(np.float32)
             + rng.uniform(-4, 4, (n, 4)).astype(np.float32))
    mels = rng.standard_normal((n, 80, 16)).astype(np.float32)
    return frames, boxes, mels


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    return 10.0 * math.log10(1.0 / max(((a - b) ** 2).mean().item(), 1e-12))


def _profile_request(mode: str, request) -> None:
    """One lip-sync request under ``torch.profiler``: wall time, device time
    of all kernels and copies (busy share), device time by int8 stage (the
    ``INT8_STAGES`` ranges of ``ops/quant.py`` carry the time of the kernels
    launched inside them) and the heaviest kernels by name."""
    wall_ms, events, kernels = _profiled(request)
    stages = {e.key: e.device_time_total / 1e3 for e in events
              if e.key in INT8_STAGES and e.device_time_total > 0}
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0 or len(stages) != (4 if mode != "float" else 0):
        raise AssertionError(f"{mode} profile: device time {busy_ms} ms, stages {stages}")
    k6_ms = sum(ms for name, ms, _ in kernels if KERNEL_NAMES["K6"] in name)
    k6_n = sum(n for name, _, n in kernels if KERNEL_NAMES["K6"] in name)
    log("lipsync", f"profile of one {mode} request: wall {wall_ms:.3f} ms under the profiler, "
        f"device kernels and copies {busy_ms:.3f} ms in {sum(c for _, _, c in kernels)} launches "
        f"(busy share {busy_ms / wall_ms:.3f}); K6's kernels by name {k6_ms:.3f} ms ({k6_n}x)"
        + ("; by int8 stage " + ", ".join(f"{k[5:]} {v:.3f} ms ({v / busy_ms:.1%})"
                                          for k, v in sorted(stages.items()))
           + f"; all else {busy_ms - sum(stages.values()):.3f} ms" if stages else ""))
    for name, ms, count in kernels[:8]:
        log("lipsync", f"  {ms:9.3f} ms {count:5d}x {name[:110]}")


def phase_lipsync(dev: dict) -> dict:
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import GanConfig, PreprocessConfig
    from lipreading_video_generation_tpu_torch.models.convert import (
        generator_state_dict_from_flax)
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm
    from lipreading_video_generation_tpu_torch.ops import quant
    from lipreading_video_generation_tpu_torch.pipelines import inference as inf

    gcfg, pre = GanConfig(), PreprocessConfig()
    sd_cpu = generator_state_dict_from_flax(flax_generator_params(gcfg.model_width, SEED))
    sd = {k: v.to("cuda") for k, v in sd_cpu.items()}
    n_convs = sum(k.endswith("conv.weight") or k.endswith("out_conv.weight") for k in sd)
    if n_convs != 51:
        raise AssertionError(f"{n_convs} convolutions in the generator, want 51")
    frames, boxes, mels = lipsync_inputs(LIPSYNC_FRAMES, SEED)
    n_batches = -(-LIPSYNC_FRAMES // pre.gen_batch_size)
    log("lipsync", f"GanConfig/PreprocessConfig defaults: width {gcfg.model_width}, faces "
        f"{gcfg.img_size}x{gcfg.img_size}, batches of {pre.gen_batch_size}, float32; "
        f"{sum(v.numel() for v in sd.values())} params in {n_convs} convs from seeded numpy via "
        f"generator_state_dict_from_flax; {LIPSYNC_FRAMES} frames of {LIPSYNC_HW} "
        f"({n_batches} batches)")
    modes = {"float": gcfg,
             "int8_dynamic": dataclasses.replace(gcfg, serve_int8=True),
             "int8_static": dataclasses.replace(gcfg, serve_int8=True, serve_int8_static=True)}
    y1, y2 = int(boxes[:, 0].min()), int(math.ceil(boxes[:, 1].max()))
    x1, x2 = int(boxes[:, 2].min()), int(math.ceil(boxes[:, 3].max()))
    outside = np.ones(LIPSYNC_HW, bool)
    outside[y1:y2 + 1, x1:x2 + 1] = False
    result = {"launches": 0, "ms": {}, "peak_mib": {}}
    outs = {}
    for mode, cfg in modes.items():
        inf.generate_frames(sd, frames, boxes, mels, cfg, pre)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        times = []
        for _ in range(3):
            before = mm.int8_matmul.launch_count
            t0 = time.perf_counter()
            out = inf.generate_frames(sd, frames, boxes, mels, cfg, pre)
            times.append(time.perf_counter() - t0)
            d = mm.int8_matmul.launch_count - before
            want = n_convs * n_batches if cfg.serve_int8 else 0
            if d != want:
                raise AssertionError(f"{mode} request launched K6 {d}x, want {want}")
            if out.dtype != np.uint8 or out.shape != frames.shape:
                raise AssertionError(f"{mode}: bad frames {out.dtype} {out.shape}")
            if not np.array_equal(out[:, outside], frames[:, outside]):
                raise AssertionError(f"{mode}: pixels outside every box changed")
            if np.array_equal(out, frames):
                raise AssertionError(f"{mode}: no face was pasted in")
        result["launches"] += mm.int8_matmul.launch_count
        if cfg.serve_int8:
            _all_by_tensor_cores("lipsync", mm.int8_matmul)
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(times)
        result["ms"][mode], result["peak_mib"][mode] = med * 1e3, peak / 2**20
        outs[mode] = out
        fps = LIPSYNC_FRAMES / med
        log("lipsync", f"{mode}: requests {[round(t * 1e3, 3) for t in times]} ms, median "
            f"{med * 1e3:.3f} ms = {fps:.1f} frames/s = {fps / gcfg.fps:.2f} x real time at "
            f"{gcfg.fps:g} fps; K6 launches a request {want} ({n_convs} x {n_batches}), routes "
            f"{mm.int8_matmul.route_counts}; frames "
            f"{out.shape} uint8, untouched outside the boxes; peak device memory "
            f"{peak / 2**20:.1f} MiB ({dev['smi']})")
    count_flops("lipsync", f"a {LIPSYNC_FRAMES}-frame dynamic-int8 generate_frames request",
                result["ms"]["int8_dynamic"] / 1e3, {"int8_matmul": n_convs * n_batches},
                inf.generate_frames, sd, frames, boxes, mels, modes["int8_dynamic"], pre)
    for mode in ("int8_dynamic", "int8_static"):
        d = np.abs(outs[mode].astype(np.float32) - outs["float"].astype(np.float32))
        log("lipsync", f"{mode} frames against float frames: mean |d| over the face boxes "
            f"{d[:, y1:y2 + 1, x1:x2 + 1].mean():.3f} gray levels, max {d.max():.0f}")

    # the generator's [0, 1] output on the first batch: int8 against float
    with torch.device("cuda"):
        gen = TalkingFaceGenerator(width=gcfg.model_width).eval()
    gen.load_state_dict(sd)
    idx = slice(0, pre.gen_batch_size)
    with torch.inference_mode():
        x = inf.gen_input_prep(torch.from_numpy(frames[idx]).to("cuda").float(),
                               torch.from_numpy(boxes[idx]).to("cuda"), gcfg.img_size)
        mel = torch.from_numpy(mels[idx]).to("cuda")[..., None]
        f = gen(mel, x)
        dyn = quant.quantized_apply(gen, mel, x)
        before = mm.int8_matmul.launch_count
        scales = quant.calibrate_activation_scales(gen, [(mel, x)])
        scales = {k: v * 1.05 for k, v in scales.items()}        # generate_frames' headroom
        if mm.int8_matmul.launch_count != before or len(scales) != n_convs:
            raise AssertionError("the calibration pass launched K6 or missed a conv")
        static = quant.quantized_apply(gen, mel, x, act_scales=scales)
    if not (torch.isfinite(f).all() and torch.isfinite(dyn).all() and torch.isfinite(static).all()):
        raise AssertionError("the generator gave non-finite output")
    psnr_d, psnr_s = _psnr(dyn, f), _psnr(static, f)
    log("lipsync", f"generator output in [0,1], batch {pre.gen_batch_size}, int8 against float on "
        f"the same weights: dynamic PSNR {psnr_d:.2f} dB (want > {PSNR_DYNAMIC}), mean |d| "
        f"{(dyn - f).abs().mean().item():.5f}; static ({len(scales)} scales x 1.05) PSNR "
        f"{psnr_s:.2f} dB (want > {PSNR_STATIC}), mean |d| {(static - f).abs().mean().item():.5f}")
    if not (psnr_d > PSNR_DYNAMIC and psnr_s > PSNR_STATIC):
        raise AssertionError(f"int8 generator PSNR: dynamic {psnr_d}, static {psnr_s}")
    del gen, x, mel, f, dyn, static

    # a float request at batch 8, the card against the CPU
    small = slice(0, 8)
    got = inf.generate_frames(sd, frames[small], boxes[small], mels[small], gcfg, pre)
    want = inf.generate_frames(sd_cpu, frames[small], boxes[small], mels[small], gcfg, pre,
                               device="cpu")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    equal = float((d == 0).mean())
    log("lipsync", f"float request of 8 frames, card vs CPU: max |d| {d.max()} gray level, "
        f"{equal:.6f} equal (want max 1 and >= {LIPSYNC_EQUAL_SHARE}); tf32 off")
    if d.max() > 1 or equal < LIPSYNC_EQUAL_SHARE:
        raise AssertionError(f"float lip-sync card vs CPU: max {d.max()}, equal {equal}")

    # where the time of a float and of a dynamic int8 request goes
    for mode in ("float", "int8_dynamic"):
        _profile_request(mode, lambda: inf.generate_frames(sd, frames, boxes, mels, modes[mode],
                                                           pre))
    return result


def phase_flops(dev: dict) -> dict:
    """MFU and HFU of the paths ``count_flops`` counted, at the medians
    their phases measured: ``mfu_report`` (model and hw TFLOP, achieved
    TFLOP/s, MFU, HFU against ``device_peak_tflops``'s bf16 peak) and each
    kernel's share of the model count, beside the card's name and power
    limit. Fails without a peak for the card or without one of the three
    paths."""
    from lipreading_video_generation_tpu_torch.utils import flops

    peak = flops.device_peak_tflops()
    if peak is None:
        raise AssertionError(f"flops: no bf16 peak for {dev['name']}")
    missing = {"serve", "train", "lipsync"} - set(FLOPS_PATHS)
    if missing:
        raise AssertionError(f"flops: paths {sorted(missing)} were not counted")
    reports = {}
    for path, rec in FLOPS_PATHS.items():
        d, sec = rec["detail"], rec["median_s"]
        report = flops.mfu_report(d, sec)
        report.update(hw_tflops=round(d["hw"] / 1e12, 4),
                      hfu=round(d["hw"] / sec / 1e12 / peak, 4))
        shares = {FLOPS_KERNELS[k]: round(v["model"] / d["model"], 6)
                  for k, v in d["kernels"].items()}
        shares["torch ops"] = round(1 - sum(v["model"] for v in d["kernels"].values())
                                    / d["model"], 6)
        reports[path] = {**report, "median_ms": round(sec * 1e3, 3), "shares_of_model": shares}
        log("flops", f"{path} ({rec['what']}; {dev['smi']}; peak {peak} TFLOP/s bf16): "
            f"{json.dumps(reports[path])}")
        if not report["mfu"] or not 0 < report["mfu"] < 1:
            raise AssertionError(f"flops: {path}: MFU {report['mfu']}")
    return reports


# [gan]: the float32 G+D step card vs CPU at width 1.0 (cuDNN without TF32
# against the CPU's kernels, through the generator, the discriminator and the
# frozen SyncNet and their backward);
# bf16 at the GanConfig defaults; the expert chain through the CLI;
# lipsync_video end to end; contrast_boost
GAN_STEP_BATCH = 2
TOL_GAN = 1e-4
# Each network's whole float32 gradient, card vs CPU, relative L2, per sync
# gate: a limit above the sound reading (the generator's gradient is
# ill-conditioned: GroupNorms of few values at 1x1-6x6 and, with the gate
# open, the SyncNet's backward) and below the reading of each fault the
# gate holds, planted on the card's side; the phase measures every fault in
# every run:
#   l1_weight: L1 weighted by 1 - syncnet_wt, disc_wt left out (G);
#   order: D's fake batch made by the generator after its update (D);
#   sync: the sync loss left out of G's gradient, its value kept (G);
#   adversarial: BCE(D(g), 1) left out of G's gradient, its value kept (G):
#     held by neither gate, its share of G's gradient is within 3x of the
#     sound reading with the gate shut and below it with the gate open.
GAN_GATES = ((0.0, {"gen": 1e-2, "disc": 1e-2}, ("l1_weight", "order")),
             (0.03, {"gen": 5e-2, "disc": 1e-2}, ("sync", "order")))
GAN_FAULT_NET = {"l1_weight": "gen", "order": "disc", "sync": "gen", "adversarial": "gen"}
# the int8 generator against the float one over the face boxes
LIPSYNC_INT8_PSNR_DB = 40.0
GAN_TIMED_STEPS, GAN_FIT_STEPS = 5, 30
GAN_SYNC_STEPS, GAN_CLI_STEPS = 64, 32
LIPSYNC_VIDEO_S = 10.24              # 256 frames at 25 fps
LIPSYNC_VIDEO_CPU_FRAMES = 8


def flax_discriminator_params(width: float, seed: int) -> dict:
    """Random weights in the tree of the Flax ``Discriminator(width=width)``
    (``ConvBlock_0…12/Conv_0``, ``Conv_0``), shapes from the port's module."""
    from lipreading_video_generation_tpu_torch.models.discriminator import Discriminator

    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        d = Discriminator(width=width)
    params = {f"ConvBlock_{i}": {"Conv_0": _flax_conv(rng, b.conv.weight.shape)}
              for i, b in enumerate(d.blocks)}
    params["Conv_0"] = _flax_conv(rng, d.out_conv.weight.shape)
    return params


def flax_syncnet_params(width: float, seed: int) -> dict:
    """Random weights in the tree of the Flax ``SyncNet(width=width)``
    (``face_blocks_i`` / ``audio_blocks_i``, each ``Conv_0`` + ``GroupNorm_0``
    with scales near 1)."""
    from lipreading_video_generation_tpu_torch.models.syncnet import SyncNet

    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        s = SyncNet(width=width)
    params = {}
    for tower in ("face_blocks", "audio_blocks"):
        for i, b in enumerate(getattr(s, tower)):
            params[f"{tower}_{i}"] = {"Conv_0": _flax_conv(rng, b.conv.weight.shape),
                                      "GroupNorm_0": _flax_norm(rng, b.conv.weight.shape[0])}
    return params


def gan_state_dicts(width: float, seed: int) -> dict:
    """Generator, discriminator and SyncNet weights from seeded numpy, bridged
    from their Flax trees (on the CPU)."""
    from lipreading_video_generation_tpu_torch.models import convert

    return {"gen": convert.generator_state_dict_from_flax(flax_generator_params(width, seed)),
            "disc": convert.discriminator_state_dict_from_flax(
                flax_discriminator_params(width, seed + 1)),
            "sync": convert.syncnet_state_dict_from_flax(flax_syncnet_params(width, seed + 2))}


def _gan_state(cfg, sds: dict, device, syncnet_wt: float = 0.0):
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    state = ttg.create_state(cfg, seed=SEED, syncnet_params=sds["sync"], device=device)
    state.gen.load_state_dict(sds["gen"])
    state.disc.load_state_dict(sds["disc"])
    state.syncnet_wt = syncnet_wt
    return state


def _zero_grad_biases(state) -> set:
    """Conv biases whose gradient is 0 in exact arithmetic: those of the
    ``ConvBlock``s whose GroupNorm has one channel a group (16 and 32
    channels at width 1.0), where each side computes float32 noise."""
    out = set()
    for net in ("gen", "disc"):
        for name, m in getattr(state, net).named_modules():
            norm = getattr(m, "norm", None)
            if norm is not None and norm.groups == norm.weight.numel():
                out.add(f"{net}.{name}.conv.bias")
    return out


@contextlib.contextmanager
def _prepared(prep: dict):
    """``train_gan.prepare_batch`` hands out ``prep`` (moved to the device
    asked for) while the block runs."""
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    real = ttg.prepare_batch
    ttg.prepare_batch = lambda batch, cfg, audio_cfg, device: {
        k: v.to(device) for k, v in prep.items()}
    try:
        yield
    finally:
        ttg.prepare_batch = real


@contextlib.contextmanager
def _gan_fault(fault, state, prep: dict):
    """Plant ``fault`` (see GAN_GATES; None: none) in ``train_gan``'s step
    on ``state`` while the block runs."""
    from lipreading_video_generation_tpu_torch.pipelines import losses
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    real_adv, real_sync, hook = losses.perceptual_adversarial_loss, ttg._sync_loss, None
    real_g_loss = losses.generator_loss
    if fault == "adversarial":
        losses.perceptual_adversarial_loss = lambda pred: real_adv(pred).detach()
    elif fault == "l1_weight":
        def l1_weight(recon, sync, perceptual, lip, syncnet_wt, disc_wt, lip_weight):
            total, terms = real_g_loss(recon, sync, perceptual, lip, syncnet_wt, disc_wt,
                                       lip_weight)
            return total + disc_wt * recon, terms

        losses.generator_loss = l1_weight
    elif fault == "sync":
        ttg._sync_loss = lambda *a: real_sync(*a).detach()
    elif fault == "order":
        calls = []

        def fake_from_new_gen(module, args):  # D's third call is its fake batch
            calls.append(1)
            if len(calls) == 3:
                with torch.no_grad():
                    return (state.gen(prep["indiv_mels"].to(state.device),
                                      prep["x"].to(state.device)),)

        hook = state.disc.register_forward_pre_hook(fake_from_new_gen)
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        losses.perceptual_adversarial_loss, ttg._sync_loss = real_adv, real_sync
        losses.generator_loss = real_g_loss
        if hook is not None:
            hook.remove()


def gan_step_capture(cfg, sds: dict, prep: dict, device, syncnet_wt: float,
                     fault=None) -> dict:
    """One ``train_gan.train_step`` from the given weights on the prepared
    batch ``prep``, with ``fault`` planted: its metrics, the generated window
    ``g`` of the G step, every G and D gradient and every updated param (on
    the CPU)."""
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    state = _gan_state(cfg, sds, device, syncnet_wt)
    seen = {}

    def keep_g(module, inputs, out):        # the G step's window (its first call)
        if "g" not in seen:
            seen["g"] = out.detach().float().cpu()

    hook = state.gen.register_forward_hook(keep_g)
    with _prepared(prep), _gan_fault(fault, state, prep):
        metrics = {k: v.item() for k, v in ttg.train_step(state, {}, cfg).items()}
    hook.remove()
    grads, params = {}, {}
    for net in ("gen", "disc"):
        for n, p in getattr(state, net).named_parameters():
            grads[f"{net}.{n}"] = p.grad.float().cpu()
            params[f"{net}.{n}"] = p.detach().cpu()
    return {"metrics": metrics, "g": seen["g"], "grads": grads, "params": params,
            "zero": _zero_grad_biases(state)}


def gan_grad_l2(got: dict, want: dict) -> dict:
    """Each network's whole gradient in ``got`` against ``want``, relative
    L2, the biases of ``_zero_grad_biases`` aside (both sides noise around
    0); and the tensors that differ most (max|d| of their largest)."""
    num, den, errs = {}, {}, {}
    for n, w in want["grads"].items():
        if n in want["zero"]:
            continue
        diff = (got["grads"][n] - w).abs()
        net = n.split(".")[0]
        num[net] = num.get(net, 0.0) + float((diff.double() ** 2).sum())
        den[net] = den.get(net, 0.0) + float((w.double() ** 2).sum())
        errs[n] = diff.max().item() / w.abs().max().item()
    return {net: math.sqrt(num[net] / den[net]) for net in num}, errs


def compare_gan_steps(got: dict, want: dict, lr: float, tol_l2: dict) -> dict:
    """``got`` (card) against ``want`` (CPU): the losses within TOL_GAN
    relative and ``g`` within TOL_GAN of its largest; each network's whole
    gradient within ``tol_l2[net]`` relative L2 (``gan_grad_l2``); every updated
    param within 2·lr, and the card's and the CPU's updated params apart by
    what Adam's first step, lr·g/(|g| + 1e-8), makes of the two gradients,
    within 1e-6: they may differ only where the two gradients differ in sign
    or are small enough for eps to matter. Returns the worst of each, and
    logs the tensors whose gradient differs most."""
    worst = {"loss": 0.0, "g": 0.0, "param": 0.0, "moved": 0, "adam": 0.0}
    for k, w in want["metrics"].items():
        d = abs(got["metrics"][k] - w)
        if d > TOL_GAN * abs(w) + 1e-7:
            raise AssertionError(f"gan step {k}: card {got['metrics'][k]} CPU {w}")
        worst["loss"] = max(worst["loss"], d / max(abs(w), 1e-12))
    worst["g"] = ((got["g"] - want["g"]).abs().max() / want["g"].abs().max()).item()
    if worst["g"] > TOL_GAN:
        raise AssertionError(f"gan step: g off by {worst['g']} of its largest")
    for n, w in want["grads"].items():
        g = got["grads"][n]
        d = got["params"][n] - want["params"][n]
        if d.abs().max().item() > 2 * lr * (1 + 1e-3):
            raise AssertionError(f"gan step {n}: a param moved {d.abs().max().item()} from "
                                 "the CPU's")
        worst["param"] = max(worst["param"], d.abs().max().item())
        worst["moved"] += int((d.abs() > 1e-6).sum())
        step = (lr * (w / (w.abs() + 1e-8) - g / (g.abs() + 1e-8)))
        worst["adam"] = max(worst["adam"], (d - step).abs().max().item())
    if worst["adam"] > 1e-6:
        raise AssertionError(f"gan step: the updated params differ by {worst['adam']} more "
                             "than Adam's first step on the two gradients makes them differ")
    worst["grad_l2"], errs = gan_grad_l2(got, want)
    log("gan", "  gradients card vs CPU, worst tensors (max|d| of their largest): " + ", ".join(
        f"{n} {e:.3g}" for n, e in sorted(errs.items(), key=lambda kv: -kv[1])[:6])
        + "; each network's whole gradient, relative L2: " + ", ".join(
            f"{net} {v:.3g} (tol {tol_l2[net]})" for net, v in worst["grad_l2"].items()))
    if any(v > tol_l2[net] for net, v in worst["grad_l2"].items()):
        raise AssertionError(f"gan step: gradients off by {worst['grad_l2']} relative L2")
    return worst


def _conv_share(kernels) -> float:
    """Device time of the library's convolution kernels (forward, data and
    weight gradients) in ms."""
    frags = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "xmma", "implicit")
    return sum(ms for name, ms, _ in kernels if any(f in name.lower() for f in frags))


def phase_gan(dev: dict) -> dict:
    import dataclasses
    import io
    import os
    import tempfile

    from lipreading_video_generation_tpu_torch import cli
    from lipreading_video_generation_tpu_torch.core.config import (AudioConfig, GanConfig,
                                                                   PreprocessConfig)
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.data import datasets
    from lipreading_video_generation_tpu_torch.data import video as video_io
    from lipreading_video_generation_tpu_torch.models.s3fd import S3FD
    from lipreading_video_generation_tpu_torch.ops import audio as audio_ops
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops import image as im
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm
    from lipreading_video_generation_tpu_torch.pipelines import inference as inf
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg
    from lipreading_video_generation_tpu_torch.pipelines import train_syncnet as tts

    t_phase = time.perf_counter()
    base = GanConfig()
    sds = gan_state_dicts(base.model_width, SEED)
    n_params = {k: sum(v.numel() for v in sd.values()) for k, sd in sds.items()}
    clips = datasets.synthetic_av_clips(n_clips=8, frames=50, img=base.img_size, seed=SEED)
    sampler = datasets.GanWindowSampler(clips, base.syncnet_T, seed=SEED)
    log("gan", f"GanConfig defaults: width {base.model_width}, faces {base.img_size}x"
        f"{base.img_size}, T {base.syncnet_T}, batch {base.batch_size}, {base.dtype}; params "
        f"{n_params} from seeded numpy via the Flax-tree bridges; batches of "
        f"synthetic_av_clips (8 clips of 50 frames)")

    # 1. one float32 G+D step at width 1.0, batch 2, card against CPU, sync gate
    # open: the batch prep on each side, then the step on the same prepared batch
    f32 = dataclasses.replace(base, dtype="float32", batch_size=GAN_STEP_BATCH)
    batch = sampler.sample_batch(GAN_STEP_BATCH)
    _zero_counts()
    prep = ttg.prepare_batch(batch, f32, AudioConfig(), "cpu")
    prep_card = ttg.prepare_batch(batch, f32, AudioConfig(), "cuda")
    prep_d = {k: (prep_card[k].cpu() - v).abs().max().item() for k, v in prep.items()}
    log("gan", f"prepare_batch card vs CPU (resize, mask, cuFFT against the CPU's FFT): max|d| "
        f"{ {k: float(f'{v:.3g}') for k, v in prep_d.items()} }")
    threads = torch.get_num_threads()
    for wt, tol_l2, faults in GAN_GATES:
        got = gan_step_capture(f32, sds, prep, "cuda", wt)
        want = gan_step_capture(f32, sds, prep, "cpu", wt)
        worst = compare_gan_steps(got, want, f32.learning_rate, tol_l2)
        # the CPU against itself with half its threads: summation order alone
        torch.set_num_threads(max(1, threads // 2))
        try:
            spread, _ = gan_grad_l2(gan_step_capture(f32, sds, prep, "cpu", wt), want)
        finally:
            torch.set_num_threads(threads)
        readings = {f: gan_grad_l2(gan_step_capture(f32, sds, prep, "cuda", wt, f),
                                   want)[0][net] for f, net in GAN_FAULT_NET.items()}
        log("gan", f"  syncnet_wt {wt}: relative L2 of the whole gradient, the CPU with "
            f"{max(1, threads // 2)} threads against {threads}: " + ", ".join(
                f"{net} {v:.3g}" for net, v in spread.items()) + "; the card with a fault "
            "planted against the CPU: " + ", ".join(
                f"{f} ({GAN_FAULT_NET[f]}) {v:.3g}" for f, v in readings.items())
            + f"; held: {', '.join(faults)}, each above its network's limit")
        for fault in faults:
            net = GAN_FAULT_NET[fault]
            if not readings[fault] > tol_l2[net]:
                raise AssertionError(f"gan step: the fault {fault!r} moves the {net} gradient "
                                     f"by {readings[fault]}, within the limit {tol_l2[net]}: "
                                     "the check cannot see it")
        log("gan", f"float32 G+D step, batch {GAN_STEP_BATCH}, syncnet_wt {wt}, card vs CPU on "
            f"the same prepared batch: losses "
            f"{ {k: round(v, 6) for k, v in got['metrics'].items()} }; worst loss "
            f"{worst['loss']:.3g} relative, g {worst['g']:.3g} of its largest (tol {TOL_GAN}); "
            f"{len(want['zero'])} conv biases with an exact-zero gradient aside; params "
            f"{worst['param']:.3g} apart (<= 2·lr = {2 * f32.learning_rate:g}), "
            f"{worst['moved']} of {sum(v.numel() for v in want['params'].values())} off by "
            f"> 1e-6, all as Adam's first step on the two gradients makes them "
            f"(within {worst['adam']:.3g})")

    # 2. bf16 at the defaults, batch 16: warm-up, timed steps, profile, a fit
    state = _gan_state(base, sds, "cuda")
    batches = [sampler.sample_batch(base.batch_size) for _ in range(GAN_TIMED_STEPS + 2)]
    ttg.train_step(state, batches[0], base)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for b in batches[1:GAN_TIMED_STEPS + 1]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = ttg.train_step(state, b, base)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**20
    if not all(math.isfinite(v.item()) for v in m.values()):
        raise AssertionError(f"bf16 GAN step: non-finite metrics {m}")
    med = statistics.median(times)
    frames_s = base.batch_size * base.syncnet_T / (med / 1e3)
    log("gan", f"bf16 G+D step at the defaults: {[round(t, 3) for t in times]} ms by CUDA events "
        f"(host batch in, device prep inside), median {med:.3f} ms = {frames_s:.1f} generated "
        f"frames/s; peak device memory {peak:.1f} MiB ({dev['smi']})")
    wall_ms, _, kernels = _profiled(lambda: ttg.train_step(state, batches[-1], base))
    busy = sum(ms for _, ms, _ in kernels)
    conv = _conv_share(kernels)
    log("gan", f"profile of one bf16 step: wall {wall_ms:.3f} ms under the profiler, device "
        f"kernels and copies {busy:.3f} ms in {sum(c for _, _, c in kernels)} launches (busy "
        f"share {busy / wall_ms:.3f}); cuDNN/library convolutions {conv:.3f} ms "
        f"({conv / busy:.1%}); by kind " + ", ".join(
            f"{kind} {ms:.3f} ms ({ms / busy:.1%}, {n}x)" for kind, (ms, n) in
            _by_kind(kernels).items()))
    for name, ms, count in kernels[:8]:
        log("gan", f"  {ms:9.3f} ms {count:5d}x {name[:110]}")
    fixed = batches[1]
    l1 = [ttg.train_step(state, fixed, base)["loss/l1"].item() for _ in range(GAN_FIT_STEPS)]
    log("gan", f"{GAN_FIT_STEPS} bf16 steps on one batch: L1 {l1[0]:.5f} -> {l1[-1]:.5f} "
        f"(min {min(l1):.5f})")
    if not l1[-1] < l1[0]:
        raise AssertionError(f"bf16 GAN fit: L1 {l1[0]} -> {l1[-1]} did not fall")
    if any(n for n in (cl.clahe_cuda.launch_count, mm.int8_matmul.launch_count,
                       mm.bf16_matmul.launch_count, *_counts().values())):
        raise AssertionError("the GAN training step launched a hand-written kernel")
    del state, got, want

    # 3. the expert chain through the command line: train-syncnet → train-gan → eval-gan
    with tempfile.TemporaryDirectory() as tmp:
        sync_ck, gan_ck = f"{tmp}/sync.pt", f"{tmp}/gan"
        sync_losses, gates = [], []
        real_sync_step, real_gate = tts.train_step, ttg.maybe_open_sync_gate

        def sync_step(*a, **kw):
            m = real_sync_step(*a, **kw)
            sync_losses.append(m["loss"].item())
            return m

        def gate(state, eval_sync_loss, cfg):
            before = state.syncnet_wt
            real_gate(state, eval_sync_loss, cfg)
            rule = (float(np.float32(cfg.syncnet_wt_after_gate))
                    if eval_sync_loss < cfg.syncnet_gate_threshold and before == 0.0 else before)
            gates.append((state.step, float(eval_sync_loss), before, state.syncnet_wt))
            if state.syncnet_wt != rule:
                raise AssertionError(f"sync gate at step {state.step}: eval sync "
                                     f"{eval_sync_loss}, syncnet_wt {before} -> "
                                     f"{state.syncnet_wt}, the rule gives {rule}")
            return state

        runs = {}
        argvs = {
            "train-syncnet": ["train-syncnet", "--synthetic", "--steps", str(GAN_SYNC_STEPS),
                              "--out", sync_ck],
            "train-gan": ["train-gan", "--synthetic", "--steps", str(GAN_CLI_STEPS),
                          "--syncnet-checkpoint", sync_ck, "--checkpoint-dir", gan_ck,
                          "--set", "gan.eval_interval=8", "--set", "gan.checkpoint_interval=16"],
            "eval-gan": ["eval-gan", "--checkpoint", gan_ck, "--synthetic",
                         "--syncnet-checkpoint", sync_ck],
        }
        tts.train_step, ttg.maybe_open_sync_gate = sync_step, gate
        try:
            for cmd, argv in argvs.items():
                out, err = io.StringIO(), io.StringIO()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                    rc = cli.main(argv)
                torch.cuda.synchronize()
                runs[cmd] = (time.perf_counter() - t0, out.getvalue())
                if rc != 0:
                    raise AssertionError(f"cli.main({argv}) returned {rc}: {err.getvalue()[-2000:]}")
        finally:
            tts.train_step, ttg.maybe_open_sync_gate = real_sync_step, real_gate
        auc_line = [ln for ln in runs["train-syncnet"][1].splitlines() if "AUC=" in ln]
        first, last = statistics.mean(sync_losses[:8]), statistics.mean(sync_losses[-8:])
        log("gan", f"train-syncnet --synthetic --steps {GAN_SYNC_STEPS} (batch {base.batch_size}, "
            f"the SyncNet in float32 as in the JAX package): {runs['train-syncnet'][0]:.2f} s; "
            f"mean loss of the first 8 steps {first:.4f}, of the last 8 {last:.4f}; "
            f"{auc_line[0] if auc_line else 'no AUC line'}")
        if len(sync_losses) != GAN_SYNC_STEPS or not last < first or not auc_line:
            raise AssertionError(f"train-syncnet: {len(sync_losses)} steps, loss {first} -> {last}")
        ck_steps = sorted(int(f[5:-3]) for f in os.listdir(gan_ck))
        opened = [g for g in gates if g[2] == 0.0 and g[3] != 0.0]
        log("gan", f"train-gan --synthetic --steps {GAN_CLI_STEPS} against that expert: "
            f"{runs['train-gan'][0]:.2f} s; evals (step, eval sync loss, syncnet_wt before -> "
            f"after) {[(s, round(l, 4), b, a) for s, l, b, a in gates]}, each by the gate's rule "
            f"(< {base.syncnet_gate_threshold}); the gate "
            f"{'opened at step %d' % opened[0][0] if opened else 'stayed shut'}; checkpoints at "
            f"{ck_steps}")
        if len(gates) != GAN_CLI_STEPS // 8 or ck_steps != [16, 32]:
            raise AssertionError(f"train-gan: {len(gates)} evals, checkpoints {ck_steps}")
        metrics = {ln.split(":")[0]: float(ln.split(":")[1]) for ln in
                   runs["eval-gan"][1].splitlines() if ln.startswith("eval/")}
        log("gan", f"eval-gan --checkpoint (step 32) --synthetic: {runs['eval-gan'][0]:.2f} s; "
            f"{metrics}")
        if sorted(metrics) != ["eval/l1", "eval/psnr", "eval/ssim", "eval/sync_loss"] or not all(
                math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"eval-gan printed {runs['eval-gan'][1]!r}")
    if any(n for n in (cl.clahe_cuda.launch_count, mm.int8_matmul.launch_count,
                       *_counts().values())):
        raise AssertionError("the GAN commands launched a hand-written kernel")

    # 4. lipsync_video end to end: a 10.24 s wav, 360x640 frames from memory
    pre, audio_cfg = PreprocessConfig(), AudioConfig()
    frames, _, _ = lipsync_inputs(LIPSYNC_FRAMES, SEED)
    gen_sd = {k: v.to("cuda") for k, v in sds["gen"].items()}
    s3fd = seeded(S3FD, SEED).to("cuda").eval()
    modes = {"float": base,
             "int8_dynamic": dataclasses.replace(base, serve_int8=True),
             "int8_static": dataclasses.replace(base, serve_int8=True, serve_int8_static=True)}
    results, gan_k6 = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(SEED)
        t = np.arange(int(LIPSYNC_VIDEO_S * audio_cfg.sample_rate)) / audio_cfg.sample_rate
        wav_path = f"{tmp}/speech.wav"
        video_io.save_wav(wav_path, (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(3 * t))
                                     + 0.02 * rng.standard_normal(len(t))).astype(np.float32))
        for mode, cfg in modes.items():
            written = {}

            def keep(path, out, fps):
                t0 = time.perf_counter()
                written.update(frames=out, fps=fps, s=time.perf_counter() - t0)

            stages = {"detection": (inf, "detect_face_tracks"),
                      "mel": (audio_ops, "melspectrogram"),
                      "generation": (inf, "generate_frames")}
            _zero_counts()
            with contextlib.ExitStack() as stack:
                timed = {k: stack.enter_context(_Stage(*v)) for k, v in stages.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = inf.lipsync_video(gen_sd, s3fd, "in-memory", wav_path, f"{tmp}/out.mp4",
                                        cfg, audio_cfg, pre,
                                        read_frames=lambda path, *conditioning: (frames, 25.0),
                                        write_video=keep)
                total = time.perf_counter() - t0
            k6 = mm.int8_matmul.launch_count
            want = 51 * 2 if cfg.serve_int8 else 0
            if res.frames.shape != (LIPSYNC_FRAMES,) + LIPSYNC_HW + (3,) or res.muxed:
                raise AssertionError(f"lipsync_video {mode}: frames {res.frames.shape}, muxed "
                                     f"{res.muxed}")
            if k6 != want or written.get("frames") is not res.frames:
                raise AssertionError(f"lipsync_video {mode}: K6 {k6}x (want {want})")
            if cfg.serve_int8:
                _all_by_tensor_cores("gan", mm.int8_matmul)
                gan_k6 += k6
            results[mode] = res
            log("gan", f"lipsync_video {mode}: {len(res.frames)} frames of {LIPSYNC_HW} from a "
                f"{LIPSYNC_VIDEO_S} s wav in {total * 1e3:.1f} ms = "
                f"{len(res.frames) / total:.1f} frames/s; stages " + ", ".join(
                    f"{k} {st.seconds * 1e3:.1f} ms" for k, st in timed.items())
                + f", write (kept in memory) {written['s'] * 1e3:.3f} ms; K6 {k6}x, routes "
                f"{mm.int8_matmul.route_counts}")
        wav = video_io.load_wav(wav_path)
    boxes = results["float"].boxes
    y1, y2 = int(boxes[:, 0].min()), int(math.ceil(boxes[:, 1].max()))
    x1, x2 = int(boxes[:, 2].min()), int(math.ceil(boxes[:, 3].max()))
    ref = results["float"].frames[:, y1:y2, x1:x2].astype(np.float64)
    for mode in ("int8_dynamic", "int8_static"):
        mse = ((results[mode].frames[:, y1:y2, x1:x2] - ref) ** 2).mean()
        psnr = 10 * math.log10(255 ** 2 / max(mse, 1e-12))
        log("gan", f"lipsync_video {mode} against float over the face boxes [{y1}:{y2}, "
            f"{x1}:{x2}]: PSNR {psnr:.2f} dB (floor {LIPSYNC_INT8_PSNR_DB})")
        if not psnr >= LIPSYNC_INT8_PSNR_DB:
            raise AssertionError(f"lipsync_video {mode}: PSNR {psnr} dB against float")
    # card against CPU: the first frames on the card's boxes and the same mel windows
    n = LIPSYNC_VIDEO_CPU_FRAMES
    mel = audio_ops.melspectrogram(torch.from_numpy(wav), audio_cfg)
    windows = inf._mel_chunks(mel, n, 25.0, audio_cfg).numpy()
    on_card = inf.generate_frames(gen_sd, frames[:n], boxes[:n], windows, base, pre)
    on_cpu = inf.generate_frames(sds["gen"], frames[:n], boxes[:n], windows, base, pre,
                                 device="cpu")
    d = np.abs(on_card.astype(np.int32) - on_cpu.astype(np.int32))
    within1 = float((d <= 1).mean())
    log("gan", f"lipsync_video's generation of {n} frames on the same boxes and mel windows, "
        f"card vs CPU: max |d| {d.max()} gray levels, {within1:.6f} within 1 (want <= 2 and "
        f">= 0.99)")
    if d.max() > 2 or within1 < 0.99:
        raise AssertionError(f"lipsync_video card vs CPU: max {d.max()}, within 1 {within1}")
    del results, on_card, on_cpu

    # 5. contrast_boost on whole frames: K1 once by the tiled route
    x = torch.from_numpy(frames[:8]).to("cuda")
    _zero_counts()
    boosted = im.contrast_boost(x)
    torch.cuda.synchronize()
    k1, k1_launches = dict(cl.clahe_cuda.route_counts), cl.clahe_cuda.launch_count
    if k1 != {"packed": 0, "tiled": 1} or boosted.dtype != torch.uint8 or \
            boosted.shape != x.shape:
        raise AssertionError(f"contrast_boost: K1 routes {k1}, {boosted.dtype} {boosted.shape}")
    L = im.rgb_to_lab(x)[..., 0]
    err = (im.clahe(L) - cl.clahe_reference(L.cpu()).to("cuda")).abs().max().item()
    log("gan", f"contrast_boost of (8, 360, 640, 3) uint8 frames: K1 {k1}; its L channel by K1 "
        f"against the plain version: max |d| {err:.3g} (tol {1 + TOL_K1}: L is not an integer "
        f"image, limit {0.2 * 45 * 80 / 256:g} not an integer count)")
    if not err <= 1 + TOL_K1:
        raise AssertionError(f"contrast_boost's K1 off its plain version by {err}")
    seconds = time.perf_counter() - t_phase
    log("gan", f"phase took {seconds:.1f} s")
    return {"int8_matmul": gan_k6, "clahe": k1_launches, "seconds": seconds}


PRE_DIFF_STEPS = 4                   # train-diffusion with the ported wav2vec2
PRE_GAN_STEPS = 4                    # train-gan with each expert
PRE_EXPERT_STEPS = 8                 # train-lip-expert
PRE_LIP_WEIGHT = 0.1
LONG_WAVE_SAMPLES = 163840           # 10.24 s at 16 kHz: T' = 511, as [gan]'s lip-sync wav
# float32 card (cuDNN without TF32, K2 by cuda_core) vs CPU (plain): summation
# order through the 7 convs and 12 layers of base wav2vec2; the map is O(1)
TOL_COND_F32 = 1e-3
# wav2vec2's gradients in a float32 diffusion step, relative L2 (as [train]'s)
TOL_W2V_GRAD = 1e-3
# the lip term of a float32 GAN step (relative); its gradient with respect to
# one generated window fed to both sides (relative L2: the expert alone). On
# an H100 the card read 1.21e-6 in one run and 3.51e-3 in another (with cuDNN
# off: PERF.md §7): a stem ReLU whose input lies within
# float32 rounding of 0 may fall on either side, and one such unit moves the
# gradient by ~1/sqrt(active units), ~2.5e-3 at the stem's 309,760 units.
# So the gate is 1e-2, and a planted fault (K2's VJP zeroed) must read above
# it. G's gradient of the lip term: relative L2 under
# GAN_GATES' limit for G with the gate shut (G's float32 backward is
# ill-conditioned on random weights, PERF.md §6), the same fault above it.
TOL_LIP = 1e-4
TOL_LIP_WINDOW_GRAD = 1e-2
TOL_LIP_GEN_GRAD = 1e-2


def _routes() -> dict:
    from lipreading_video_generation_tpu_torch.ops import attention as att

    return {"small_mha": dict(att.small_mha.route_counts),
            "flash_attention": dict(att.flash_attention.route_counts)}


def _route_delta(before: dict) -> dict:
    return {k: {r: n - before[k][r] for r, n in v.items() if n != before[k][r]}
            for k, v in _routes().items()}


def phase_pretrained(dev: dict) -> dict:
    """The pretrained encoders at full width on random weights from seed 0,
    written in their published layouts: ``port-wav2vec2 --pth`` on a base
    (768/12/12/3072) HF ``Wav2Vec2ForCTC``-layout file, ``train-diffusion
    --wav2vec2-checkpoint`` and ``sample-diffusion`` at the
    ``DiffusionConfig`` defaults (K2 12× a step or request by sm90), the
    base encoder alone on a 10.24 s wave (K3 12× by sm90), ``port-avhubert``
    (``--selftest``, then ``--pth`` at base width) → ``train-gan
    --avhubert-checkpoint`` at the ``GanConfig`` defaults (K2 24× a step by
    cuda_core), ``train-lip-expert`` → ``train-gan --lip-expert-checkpoint``
    on transcript batches (K2 4× a step by cuda_core); card against CPU:
    ``encode_condition``, a float32 diffusion step's wav2vec2 gradients, a
    float32 GAN step's lip term and its gradients."""
    import dataclasses
    import os
    import tempfile

    from lipreading_video_generation_tpu_torch import cli
    from lipreading_video_generation_tpu_torch.core.config import (AudioConfig, DiffusionConfig,
                                                                   GanConfig)
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.data import datasets as tdata
    from lipreading_video_generation_tpu_torch.models import avhubert as tavh
    from lipreading_video_generation_tpu_torch.models import ports, selftest
    from lipreading_video_generation_tpu_torch.models.lip_expert import avhubert_video_transform
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
    from lipreading_video_generation_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder, num_frames
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg
    from lipreading_video_generation_tpu_torch.pipelines import train_lip_expert as ttle

    phase_t0 = time.perf_counter()
    launches = dict.fromkeys(_counts(), 0)
    walls = {}

    def drive(name, fn, want: dict, routes: dict, graphed=None):
        """Run one stage of the path: its wall time, its launches (added to
        the phase's), each exactly ``want`` and by the routes ``routes``
        through the wrappers. ``graphed`` (a training run): (the routes its
        steps must take, the launches of a step); the run goes under a
        device trace, which must hold the wrappers' launches and a step's
        again for each replay, and the phase adds the trace's launches."""
        before, before_r, before_t = _counts(), _routes(), _train_routes()
        t0 = time.perf_counter()
        out, traced = (fn(), None) if graphed is None else _traced_launches(fn)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        d, r = _delta(before), _route_delta(before_r)
        want = dict(dict.fromkeys(d, 0), **want)
        if d != want or any(r[k] != v for k, v in routes.items()):
            raise AssertionError(f"{name}: launches {d} by {r}, want {want} by {routes}")
        ran, also = d, ""
        if graphed is not None:
            took = {k: n - before_t[k] for k, n in _train_routes().items()}
            if took != graphed[0] or traced != _with_replays(d, graphed[1], took["graph"]):
                raise AssertionError(f"{name}: steps by the routes {took} (want {graphed[0]}); "
                                     f"the device trace holds {traced}")
            ran, also = traced, f"; steps by the routes {took}, in the device trace {traced}"
        for k, v in ran.items():
            launches[k] += v
        log("pretrained", f"{name}: {walls[name]:.3f} s; launches {d} by {r}{also}")
        return out

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_pretrained_")
    root = work.name
    try:
        # --- 1. wav2vec2 conditioning ---------------------------------------
        pth = os.path.join(root, "wav2vec2_base_ctc.pth")
        t0 = time.perf_counter()
        selftest.make_wav2vec2_selftest_pth(pth, SEED, **selftest.BASE_WAV2VEC2)
        log("pretrained", f"wrote a base Wav2Vec2ForCTC-layout state dict "
            f"({os.path.getsize(pth) / 2**20:.1f} MiB) in {time.perf_counter() - t0:.2f} s")
        w2v = os.path.join(root, "w2v")
        if drive("port-wav2vec2 --pth", lambda: cli.main(["port-wav2vec2", "--pth", pth,
                                                            "--out", w2v]), {}, {}) != 0:
            raise AssertionError("port-wav2vec2 failed")
        w2v_sd, w2v_cfg = ports.load_wav2vec2_params(w2v)
        cfg = ports.diffusion_cfg_with_wav2vec2(DiffusionConfig(), w2v_cfg)
        if cfg != DiffusionConfig(audio_encoder="wav2vec2") or num_frames(cfg.audio_samples) != 12:
            raise AssertionError(f"base wav2vec2 config {w2v_cfg}")
        n_w2v = sum(v.numel() for v in w2v_sd.values())
        ck = os.path.join(root, "ck")
        steps, losses = [], []
        n = PRE_DIFF_STEPS
        # through the wrappers the eager first step and the eval at the last
        # (K2 12, K3 16 each); each replay of the captured step again in the trace
        per_step = {"small_mha": 12, "flash_attention": 16, "flash_bwd_dkv": 16,
                    "flash_bwd_dq": 16}
        with _timed(ttd, "train_step", steps, lambda m: losses.append(m["loss"].item())):
            rc = drive("train-diffusion --wav2vec2-checkpoint", lambda: cli.main(
                ["train-diffusion", "--synthetic", "--wav2vec2-checkpoint", w2v, "--set",
                 "diffusion.audio_encoder=wav2vec2", "--steps", str(n), "--checkpoint-dir", ck,
                 "--checkpoint-every", str(n)]),
                {"small_mha": 24, "flash_attention": 32, "flash_bwd_dkv": 16, "flash_bwd_dq": 16},
                {"small_mha": {"sm90": 24}, "flash_attention": {"sm90": 32}},
                ({"eager": 1, "capture": 1, "graph": n - 1}, per_step))
        if rc != 0 or len(steps) != n or not np.isfinite(losses).all():
            raise AssertionError(f"train-diffusion: rc {rc}, {len(steps)} steps, losses {losses}")
        saved = ttd.load_checkpoint(ttd.latest_checkpoint(ck))["params"]
        moved = float((saved["audio_encoder.proj.weight"] - w2v_sd["proj.weight"]).abs().max())
        if not 0 < moved < 1e-2:
            raise AssertionError(f"the wav2vec2 weights moved by {moved} in {n} steps")
        del saved
        log("pretrained", f"train-diffusion --wav2vec2-checkpoint at the DiffusionConfig "
            f"defaults (batch {cfg.batch_size}, {cfg.dtype}; wav2vec2 base {n_w2v} params, "
            f"trained jointly, T' = 12): step times {[round(x * 1e3, 1) for x in steps]} ms "
            f"({dev['smi']}); losses {[round(x, 5) for x in losses]}; its weights moved by "
            f"{moved:.3g} (proj, max)")
        out = os.path.join(root, "sample")
        rc = drive("sample-diffusion", lambda: cli.main(
            ["sample-diffusion", "--checkpoint", ck, "--frames", str(DIFF_FRAMES), "--ddim-steps",
             str(DIFF_STEPS), "--out", out, "--set", "diffusion.audio_encoder=wav2vec2"]),
            {"small_mha": 12, "flash_attention": 16 * DIFF_STEPS},
            {"small_mha": {"sm90": 12}, "flash_attention": {"sm90": 16 * DIFF_STEPS}})
        frames = np.stack([read_png(f"{out}.{j:04d}.png") for j in range(DIFF_FRAMES)])
        if rc != 0 or frames.shape != (DIFF_FRAMES, 128, 128, 3) or not all(
                f.std() > 0 for f in frames):
            raise AssertionError(f"sample-diffusion: rc {rc}, frames {frames.shape}")

        state = ttd.create_state(cfg, seed=SEED, device="cuda", wav2vec2_checkpoint=w2v)
        batch = train_batch(cfg, cfg.batch_size, SEED + 40)
        ttd.train_step(state, batch, cfg)         # eager: the key's first step
        ttd.train_step(state, batch, cfg)         # the capture
        busy_ms = _profile_step("pretrained", lambda: ttd.train_step(state, batch, cfg)[
            "loss"].item(), "replayed train-diffusion step with wav2vec2")
        del state

        # encode_condition and a float32 step, card against the CPU plain path
        cfg32 = dataclasses.replace(cfg, dtype="float32", dropout=0.0, im_size=64)
        model = seeded(lambda: UNetAudio(cfg32), SEED)
        sd32 = ports.graft_wav2vec2_into_diffusion(model.state_dict(), w2v_sd)
        gen = torch.Generator().manual_seed(SEED + 45)
        for name, v in sd32.items():      # the zero-initialised layers (the output conv)
            if not v.any():
                sd32[name] = 0.02 * torch.randn(v.shape, generator=gen)
        batch = train_batch(cfg32, 2, SEED + 41, size=64)
        prep = ttd.prepare_batch(batch, cfg32, "cpu")
        conds = {}
        for device in ("cuda", "cpu"):
            model.load_state_dict(sd32)
            with torch.no_grad():
                conds[device] = model.to(device).eval().encode_condition(
                    prep["audio"].to(device), prep["cond"].to(device)).cpu()
        cond_err = (conds["cuda"] - conds["cpu"]).abs().max().item()
        t = np.array([17, 402])
        noise = np.random.default_rng(SEED + 42).standard_normal((2, 64, 64, 3)).astype(np.float32)
        def w2v_step(device):
            st = ttd.create_state(cfg32, seed=SEED, device=device)
            st.model.load_state_dict(sd32)
            p = ttd.prepare_batch(batch, cfg32, device)
            tt, nz = ttd.draw_t_noise(st, p["target"], cfg32.num_timesteps, t, noise)
            loss = ttd.noise_mse(st.model(st.scheduler.add_noise(p["target"], nz, tt), p["cond"],
                                          p["audio"], tt), nz)
            loss.backward()
            return (loss.item(), torch.cat([
                q.grad.flatten().double().cpu() for k, q in st.model.named_parameters()
                if k.startswith("audio_encoder.")]))

        # the card's K3/K4/K5 launches by the tiled kernels of csrc/flash_fwd.cu
        # and flash_bwd.cu
        grads = {"cuda": _tiled_run("pretrained", "float32 diffusion step with wav2vec2 at "
                                    "64x64", lambda: w2v_step("cuda")),
                 "cpu": w2v_step("cpu")}
        loss_rel = abs(grads["cuda"][0] - grads["cpu"][0]) / abs(grads["cpu"][0])
        w2v_rel = ((grads["cuda"][1] - grads["cpu"][1]).norm() / grads["cpu"][1].norm()).item()
        log("pretrained", f"float32, card vs CPU plain path: encode_condition (2 waves of "
            f"{cfg.audio_samples} samples, base wav2vec2, K2 by cuda_core) max|d| {cond_err:.3g} "
            f"(tol {TOL_COND_F32}, map max {conds['cpu'].abs().max().item():.3g}); a diffusion "
            f"step at 64x64, batch 2: loss {grads['cuda'][0]:.7g} vs {grads['cpu'][0]:.7g} (rel "
            f"{loss_rel:.3g}, tol {TOL_TRAIN_LOSS}), wav2vec2 gradients rel L2 {w2v_rel:.3g} (tol "
            f"{TOL_W2V_GRAD})")
        if not (cond_err <= TOL_COND_F32 and loss_rel <= TOL_TRAIN_LOSS
                and w2v_rel <= TOL_W2V_GRAD):
            raise AssertionError(f"wav2vec2 card vs CPU: cond {cond_err}, loss {loss_rel}, "
                                 f"grad {w2v_rel}")
        del model, grads

        # --- 2. the base encoder on a 10.24 s wave: K3 ------------------------
        enc = Wav2Vec2Encoder(**w2v_cfg, dtype=torch.bfloat16)
        enc.load_state_dict(w2v_sd)
        enc = enc.to("cuda").eval()
        wave = ttd.normalize_audio(torch.from_numpy(np.random.default_rng(SEED + 43).standard_normal(
            (1, LONG_WAVE_SAMPLES)).astype(np.float32))).to("cuda")
        seen, real = [], tavh.mha

        def keep(q, k, v, num_heads, *a, **kw):     # each layer's attention, as mha runs it
            o = real(q, k, v, num_heads, *a, **kw)
            seen.append((q, k, v, o))
            return o

        tavh.mha = keep
        try:
            with torch.no_grad():
                feats = drive("wav2vec2 on a 10.24 s wave", lambda: enc(wave),
                              {"flash_attention": 12}, {"flash_attention": {"sm90": 12}})
        finally:
            tavh.mha = real

        def heads(x):
            return x.reshape(x.shape[0], x.shape[1], 12, 64).transpose(1, 2)

        k3_err = k3_rel = 0.0
        for q, k, v, o in seen:     # as assert_close: |d| <= tol + tol·|want|
            want = att.flash_reference(heads(q), heads(k), heads(v), p_dtype=torch.bfloat16)[0]
            d = (o.float() - want.transpose(1, 2).reshape(o.shape).float()).abs()
            k3_err = max(k3_err, d.max().item())
            k3_rel = max(k3_rel, (d / (1 + want.transpose(1, 2).reshape(o.shape).float().abs()))
                         .max().item())
        if (len(seen) != 12 or feats.shape != (1, 511, 768) or not torch.isfinite(feats).all()
                or k3_rel > TOL_K3_BF16):
            raise AssertionError(f"long wave: {tuple(feats.shape)}, K3 max|d| {k3_err}, "
                                 f"max|d|/(1 + |O|) {k3_rel}")
        log("pretrained", f"base wav2vec2 (bf16) on {LONG_WAVE_SAMPLES} samples: T' = 511, "
            f"12 layers of (1,12,511,64) attention by K3 (sm90), each layer's O against "
            f"flash_reference (P rounded to bf16): max|d| {k3_err:.3g}, max|d|/(1 + |O|) "
            f"{k3_rel:.3g} (tol {TOL_K3_BF16} abs/rel, one bf16 ulp of O); features finite")
        del enc, seen

        # --- 3. AV-HuBERT as the GAN's lip expert ------------------------------
        small = os.path.join(root, "av_small")
        if drive("port-avhubert --selftest", lambda: cli.main(
                ["port-avhubert", "--selftest", "--out", small]), {"small_mha": 2},
                {"small_mha": {"cuda_core": 2}}) != 0:
            raise AssertionError("port-avhubert --selftest failed")
        av_pth, av = os.path.join(root, "avhubert_base.pt"), os.path.join(root, "av")
        selftest.make_avhubert_selftest_pth(av_pth, SEED, **selftest.BASE_AVHUBERT)
        if drive("port-avhubert --pth (base)", lambda: cli.main(
                ["port-avhubert", "--pth", av_pth, "--out", av]), {}, {}) != 0:
            raise AssertionError("port-avhubert --pth failed")
        gcfg = GanConfig()
        lip_set = ["--set", f"gan.lip_weight={PRE_LIP_WEIGHT}"]
        g_steps, g_lips = [], []
        m = PRE_GAN_STEPS
        with _timed(ttg, "train_step", g_steps, lambda x: g_lips.append(x["loss/lip"].item())):
            rc = drive("train-gan --avhubert-checkpoint", lambda: cli.main(
                ["train-gan", "--synthetic", "--avhubert-checkpoint", av, "--steps", str(m)]
                + lip_set), {"small_mha": 24 * m}, {"small_mha": {"cuda_core": 24 * m}})
        if rc != 0 or len(g_lips) != m or not all(np.isfinite(x) and x > 0 for x in g_lips):
            raise AssertionError(f"train-gan --avhubert-checkpoint: rc {rc}, lip terms {g_lips}")
        log("pretrained", f"train-gan --avhubert-checkpoint (base AV-HuBERT, float32 in the "
            f"{gcfg.dtype} step) at the GanConfig defaults (width {gcfg.model_width}, batch "
            f"{gcfg.batch_size}, T {gcfg.syncnet_T}), lip_weight {PRE_LIP_WEIGHT}: step times "
            f"{[round(x * 1e3, 1) for x in g_steps]} ms ({dev['smi']}); lip terms "
            f"{[round(x, 5) for x in g_lips]}")

        # --- 4. the seq2seq expert ---------------------------------------------
        le = os.path.join(root, "lip_expert.pt")
        e_steps, e_losses = [], []
        k = PRE_EXPERT_STEPS
        with _timed(ttle, "train_step", e_steps, lambda x: e_losses.append(x["loss"].item())):
            rc = drive("train-lip-expert", lambda: cli.main(
                ["train-lip-expert", "--synthetic", "--steps", str(k), "--out", le]),
                {"small_mha": 4 * k}, {"small_mha": {"cuda_core": 4 * k}})
        if rc != 0 or not np.isfinite(e_losses).all():
            raise AssertionError(f"train-lip-expert: rc {rc}, losses {e_losses}")
        s_steps, s_lips = [], []
        with _timed(ttg, "train_step", s_steps, lambda x: s_lips.append(x["loss/lip"].item())):
            rc = drive("train-gan --lip-expert-checkpoint", lambda: cli.main(
                ["train-gan", "--synthetic", "--lip-expert-checkpoint", le, "--steps", str(m)]
                + lip_set), {"small_mha": 4 * m}, {"small_mha": {"cuda_core": 4 * m}})
        if rc != 0 or len(s_lips) != m or not all(np.isfinite(x) and x > 0 for x in s_lips):
            raise AssertionError(f"train-gan --lip-expert-checkpoint: rc {rc}, lips {s_lips}")
        log("pretrained", f"train-lip-expert --synthetic (default_expert: embed 256, stem 64, "
            f"2+2 layers, 4 heads; batch {gcfg.batch_size}): step times "
            f"{[round(x * 1e3, 1) for x in e_steps]} ms, losses "
            f"{[round(x, 4) for x in e_losses]}; train-gan --lip-expert-checkpoint on "
            f"transcript batches: step times {[round(x * 1e3, 1) for x in s_steps]} ms, lip "
            f"terms (character cross-entropy) {[round(x, 4) for x in s_lips]} ({dev['smi']})")

        # the lip term of a float32 step and its gradients, card against CPU
        cfg32 = dataclasses.replace(gcfg, dtype="float32", batch_size=2,
                                    lip_weight=PRE_LIP_WEIGHT)
        sds = gan_state_dicts(cfg32.model_width, SEED)
        expert_sd = ttle.load_params(le)
        clips = tdata.synthetic_gan_clips(n_clips=4, frames=30, seed=SEED + 44, with_text=True)
        hb = tdata.GanWindowSampler(clips, cfg32.syncnet_T, seed=SEED, with_text=True
                                    ).sample_batch(2)
        prep = ttg.prepare_batch(hb, cfg32, AudioConfig(), "cpu")
        window = None

        def lip_step(device, fault=False):
            """(lip term, its gradient w.r.t. the CPU's generated window, w.r.t.
            the device's own window, G's gradient); ``fault``: K2's VJP gives
            zeros (a planted fault the gates must see)."""
            nonlocal window
            real = att._SmallMHA.backward
            if fault:
                att._SmallMHA.backward = staticmethod(
                    lambda ctx, g: tuple(torch.zeros_like(t) for t in ctx.saved_tensors)
                    + (None, None))
            try:
                st = ttg.create_state(cfg32, seed=SEED, device=device,
                                      lip_expert_params=expert_sd)
                st.gen.load_state_dict(sds["gen"])
                g = st.gen(prep["indiv_mels"].to(device), prep["x"].to(device))
                g.retain_grad()
                lip = ttg.lip_loss(st.lip_expert, g, prep["gt"].to(device), hb["text_tokens"])
                lip.backward()
                if window is None:                  # the CPU's window, for the expert alone
                    window = g.detach().clone()
                w = window.to(device).detach().requires_grad_()
                ttg.lip_loss(st.lip_expert, w, prep["gt"].to(device), hb["text_tokens"]
                             ).backward()
                return (lip.item(), w.grad.double().cpu(), g.grad.double().cpu(), torch.cat(
                    [q.grad.flatten().double().cpu() for q in st.gen.parameters()]))
            finally:
                att._SmallMHA.backward = real

        def rel_l2(got, want):
            return [abs(got[0] - want[0]) / abs(want[0])] + [
                ((got[i] - want[i]).norm() / want[i].norm()).item() for i in (1, 2, 3)]

        want = lip_step("cpu")
        lip_rel, win_rel, own_rel, gen_rel = rel_l2(lip_step("cuda"), want)
        with torch.backends.cudnn.flags(enabled=False):
            off_rel = rel_l2(lip_step("cuda"), want)[1]
        fault = rel_l2(lip_step("cuda", fault=True), want)
        # how near 0 the expert's stem ReLUs are cut on the CPU's window: a unit
        # within float32 rounding of 0 may fall on either side on the card
        stems = ttle.default_expert(num_frames=cfg32.syncnet_T)
        stems.load_state_dict(expert_sd)
        x, nearest = avhubert_video_transform(window * 255.0).permute(0, 4, 1, 2, 3), []
        with torch.no_grad():
            for conv in (stems.encoder.stem1, stems.encoder.stem2, stems.encoder.stem3):
                y = conv(x)
                nearest.append((y.abs().min().item(), int((y.abs() < 1e-6).sum()), y.numel()))
                x = torch.relu(y)
        log("pretrained", f"float32 GAN lip term at width {cfg32.model_width}, batch 2, the "
            f"trained seq2seq expert, card vs CPU plain path: {lip_rel:.3g} relative (tol "
            f"{TOL_LIP}); its gradient w.r.t. the same generated window rel L2 {win_rel:.3g} "
            f"(tol {TOL_LIP_WINDOW_GRAD}; cuDNN off: {off_rel:.3g}), w.r.t. each side's own "
            f"window {own_rel:.3g} (read, not held); G's gradient rel L2 {gen_rel:.3g} (tol "
            f"{TOL_LIP_GEN_GRAD}); with K2's VJP zeroed on the card (a planted fault): window "
            f"{fault[1]:.3g}, G {fault[3]:.3g}; the expert's three stem convolutions on the "
            f"CPU's window: min |pre-activation| "
            + ", ".join(f"{m:.3g} ({n} of {t} within 1e-6 of 0)" for m, n, t in nearest))
        if not (lip_rel <= TOL_LIP and win_rel <= TOL_LIP_WINDOW_GRAD
                and gen_rel <= TOL_LIP_GEN_GRAD):
            raise AssertionError(f"lip term card vs CPU: {lip_rel}, {win_rel}, {gen_rel}")
        if not (fault[1] > TOL_LIP_WINDOW_GRAD and fault[3] > TOL_LIP_GEN_GRAD):
            raise AssertionError(f"the gates do not see K2's VJP zeroed: {fault}")
    finally:
        work.cleanup()
    log("pretrained", "stage wall times: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; the profiled diffusion step's kernels {busy_ms:.3f} ms; phase took "
        f"{time.perf_counter() - phase_t0:.1f} s")
    return {"launches": launches}


FT_SYNTH_CLIPS = 256           # train-feature-transformer --synthetic's clips (5 frames of 32x32)
FT_DATA_CLIPS = 4              # records of lipread_records for --data-root --max-clips
DN_HW = 224                    # DenseNet121's published input size
DN_BATCH = 64
DN_CHECK_FRAMES = 8            # frames of 64x64 in the card-vs-CPU DenseNet check
# DenseNet121 float32, card (cuDNN without TF32) vs CPU: summation order through
# 120 convolutions and 121 BatchNorms (eval mode); of the largest |feature|.
TOL_DENSENET = 1e-3
# a FeatureTransformer train step at the defaults (float32, dropout 0), card (K2
# by cuda_core, cuBLAS without TF32) vs CPU (_mha_einsum): summation order
# only through 2 blocks, the max over time, the head and the backward
TOL_FT_LOSS = 1e-5             # relative
TOL_FT_GRAD = 1e-4             # relative L2 of the whole gradient
FT_FAULT_SCALE = 1.01          # K2's output scaled on the card: a fault the gates must see


def phase_features(dev: dict) -> dict:
    """The DenseNet feature path at the published widths on random weights
    from seed 0: ``port-densenet --selftest``; DenseNet121 card against CPU
    (float32); ``embed_frames`` on the CLI's 1,280 synthetic frames of
    32×32 and a batch of 64 frames of 224×224; a ``FeatureTransformer``
    train step at the ``FeatureTransformerConfig`` defaults (1024 features,
    2 heads: K2 at head dim 512 by ``cuda_core``) card against CPU, with a
    planted fault; ``train-feature-transformer --synthetic`` (K2 122×) and
    ``--data-root`` over ``lipread_records`` (K1 once a record by
    ``packed``, K2 2× a step and 2× in the eval)."""
    import contextlib as ctx
    import io
    import os
    import tempfile

    from lipreading_video_generation_tpu_torch import cli
    from lipreading_video_generation_tpu_torch.core.config import FeatureTransformerConfig
    from lipreading_video_generation_tpu_torch.data.datasets import synthetic_word_clips
    from lipreading_video_generation_tpu_torch.models import ports
    from lipreading_video_generation_tpu_torch.models.densenet import (DenseNet121,
                                                                       imagenet_preprocess)
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.pipelines import feature_extraction as tfx
    from lipreading_video_generation_tpu_torch.pipelines import lipreading_e2e as e2e

    phase_t0 = time.perf_counter()
    launches = {"clahe": 0, "small_mha": 0}
    walls = {}

    def run_cli(name, argv):
        """``cli.main(argv)`` on the card with the counts zeroed first: its
        wall time, printed lines (echoed) and launches by route."""
        _zero_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with ctx.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            log("features", f"  {name}: {line}")
        if rc != 0:
            raise AssertionError(f"{name}: rc {rc}")
        got = {"clahe": dict(cl.clahe_cuda.route_counts),
               "small_mha": dict(att.small_mha.route_counts)}
        for k in launches:
            launches[k] += sum(got[k].values())
        return out.getvalue(), got

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_features_")
    root = work.name
    try:
        # --- 1. port-densenet --selftest; DenseNet121 card vs CPU --------------
        art = os.path.join(root, "densenet.pt")
        text, got = run_cli("port-densenet --selftest", ["port-densenet", "--selftest", "--out",
                                                         art])
        if sum(got["small_mha"].values()) or sum(got["clahe"].values()) or "feature_l2" not in text:
            raise AssertionError(f"port-densenet --selftest: {got}, {text!r}")
        sd = ports.load_densenet_variables(art)
        model = ports._materialise(DenseNet121, sd).eval()
        x = _uniform((DN_CHECK_FRAMES, 64, 64, 3), -2, 2, SEED + 80).cpu()
        with torch.no_grad():
            want = model(x)
            got_card = model.to("cuda")(x.to("cuda")).cpu()
        dn_err = ((got_card - want).abs().max() / want.abs().max()).item()
        log("features", f"DenseNet121 (growth 32, blocks (6,12,24,16), 1024 features; "
            f"{sum(v.numel() for v in sd.values())} values) float32 on the port-densenet "
            f"artifact, {DN_CHECK_FRAMES} frames of 64x64, card (cuDNN, tf32 off) vs CPU: "
            f"max|d| / max|f| {dn_err:.3g} (tol {TOL_DENSENET})")
        if not dn_err <= TOL_DENSENET:
            raise AssertionError(f"DenseNet121 card vs CPU: {dn_err}")

        # --- 2. embed_frames: the CLI's 1,280 frames; 64 frames of 224x224 -----
        clips, _ = synthetic_word_clips(n=FT_SYNTH_CLIPS, t=5, num_classes=64)
        stacked = np.stack(clips)[..., None]                       # (256, 5, 32, 32, 1)
        tfx.embed_frames(model, stacked[:8], batch_frames=512, device="cuda")   # warm-up
        embed_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            feats = tfx.embed_frames(model, stacked, batch_frames=512, device="cuda")
            embed_s.append(time.perf_counter() - t0)
        embed_peak = torch.cuda.max_memory_allocated() / 2**20
        n_frames = stacked.shape[0] * stacked.shape[1]
        if feats.shape != (FT_SYNTH_CLIPS, 5, 1024) or not np.isfinite(feats).all():
            raise AssertionError(f"embed_frames: {feats.shape}")
        big = torch.from_numpy(np.random.default_rng(SEED + 81).integers(
            0, 256, (DN_BATCH, DN_HW, DN_HW, 3), dtype=np.uint8))
        xb = imagenet_preprocess(big.to("cuda"))
        with torch.no_grad():
            model(xb)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fwd_ms = [_event_ms(lambda: model(xb), 1) for _ in range(5)]
            fwd_peak = torch.cuda.max_memory_allocated() / 2**20
            wall_ms, _, kernels = _profiled(lambda: model(xb))
        host_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            tfx.embed_frames(model, big.numpy()[:, None], batch_frames=DN_BATCH, device="cuda")
            host_s.append(time.perf_counter() - t0)
        busy = sum(ms for _, ms, _ in kernels)
        n_launch = sum(n for _, _, n in kernels)
        fwd = statistics.median(fwd_ms)
        log("features", f"embed_frames on {n_frames} frames of 32x32 (the CLI's synthetic "
            f"{FT_SYNTH_CLIPS} clips x 5), batches of 512, host uint8 in, host features out: "
            f"{[round(s * 1e3, 2) for s in embed_s]} ms = "
            f"{n_frames / statistics.median(embed_s):.1f} frames/s, peak {embed_peak:.1f} MiB; "
            f"DenseNet121 forward on {DN_BATCH} frames of {DN_HW}x{DN_HW} on the card: "
            f"{[round(t, 3) for t in fwd_ms]} ms (median {fwd:.3f} ms = "
            f"{DN_BATCH / fwd * 1e3:.1f} frames/s), peak {fwd_peak:.1f} MiB; under the profiler "
            f"{busy:.3f} ms of kernels in {n_launch} launches a batch (wall {wall_ms:.3f} ms, "
            f"busy {busy / wall_ms:.3f}); through embed_frames from host uint8 "
            f"{[round(s * 1e3, 2) for s in host_s]} ms ({dev['smi']})")
        for name, ms, count in kernels[:6]:
            log("features", f"  {ms:9.3f} ms {count:5d}x {name[:110]}")
        del xb, big

        # --- 3. a FeatureTransformer train step, card vs CPU, a planted fault --
        cfg0 = FeatureTransformerConfig(dropout=0.0, head_dropout=0.0)
        rng = np.random.default_rng(SEED + 82)
        fb = torch.from_numpy(rng.standard_normal((64, 5, 1024)).astype(np.float32))
        lb = torch.from_numpy(rng.integers(0, cfg0.num_classes, 64))
        weights = tfx.create_state(cfg0, SEED, device="cpu").model.state_dict()

        def ft_step(device, fault=False):
            st = tfx.create_state(cfg0, SEED, device=device)
            st.model.load_state_dict(weights)
            real = att._small_mha_launch
            if fault:
                att._small_mha_launch = lambda *a: real(*a) * FT_FAULT_SCALE
            before = dict(att.small_mha.route_counts)
            try:
                m = tfx.train_step(st, fb, lb)
            finally:
                att._small_mha_launch = real
            took = {r: n - before[r] for r, n in att.small_mha.route_counts.items()
                    if n != before[r]}
            grad = torch.cat([p.grad.flatten().double().cpu() for p in st.model.parameters()])
            return m["loss"].item(), grad, took

        want_loss, want_grad, _ = ft_step("cpu")
        loss, grad, took = ft_step("cuda")
        if took != {"cuda_core": cfg0.num_layers}:
            raise AssertionError(f"FeatureTransformer step: K2 routes {took}, want "
                                 f"{cfg0.num_layers} by cuda_core")
        f_loss, f_grad, _ = ft_step("cuda", fault=True)

        def rel(lo, gr):
            return abs(lo - want_loss) / abs(want_loss), ((gr - want_grad).norm()
                                                          / want_grad.norm()).item()

        loss_rel, grad_rel = rel(loss, grad)
        fault_loss, fault_grad = rel(f_loss, f_grad)
        log("features", f"FeatureTransformer train step at the FeatureTransformerConfig defaults "
            f"(1024 features, 2 heads: d 512, dense_dim 4, 2 layers, {cfg0.num_classes} "
            f"classes; dropout 0), batch 64, float32, card (K2 {took}) vs CPU: loss "
            f"{loss:.7g} vs {want_loss:.7g} (rel {loss_rel:.3g}, tol {TOL_FT_LOSS}), gradient "
            f"rel L2 {grad_rel:.3g} (tol {TOL_FT_GRAD}); K2's output x{FT_FAULT_SCALE} on the card "
            f"(a planted fault): loss {fault_loss:.3g}, gradient {fault_grad:.3g}")
        if not (loss_rel <= TOL_FT_LOSS and grad_rel <= TOL_FT_GRAD):
            raise AssertionError(f"FeatureTransformer step card vs CPU: {loss_rel}, {grad_rel}")
        if not fault_grad > TOL_FT_GRAD:
            raise AssertionError(f"the gate does not see K2's output scaled: {fault_grad}")

        # --- 4. train-feature-transformer --synthetic at the defaults ----------
        cfg = FeatureTransformerConfig()
        n_val = max(1, int(cfg.val_split * FT_SYNTH_CLIPS))
        steps = cfg.num_epochs * ((FT_SYNTH_CLIPS - n_val) // 64)
        stages = {"embed": _Stage(tfx, "embed_frames"), "train": _Stage(tfx, "train"),
                  "step": _Stage(tfx, "train_step")}
        with ctx.ExitStack() as stack:
            for stage in stages.values():
                stack.enter_context(stage)
            text, got = run_cli("train-feature-transformer --synthetic",
                                ["train-feature-transformer", "--synthetic"])
        want_k2 = cfg.num_layers * (steps + 1)
        if got["small_mha"] != {"sm90": 0, "cuda_core": want_k2} or sum(got["clahe"].values()):
            raise AssertionError(f"train-feature-transformer --synthetic: launches {got}, want "
                                 f"K2 {want_k2} by cuda_core")
        acc = float(text.split("val accuracy=")[1].split()[0])
        s = stages
        log("features", f"train-feature-transformer --synthetic ({FT_SYNTH_CLIPS} clips, {n_val} "
            f"held out, batch 64: {steps} steps; the FeatureTransformerConfig defaults): K2 "
            f"{want_k2} by cuda_core ({cfg.num_layers} a step and {cfg.num_layers} in the eval), "
            f"as derived; val accuracy {acc:.4f}; wall {walls['train-feature-transformer --synthetic']:.3f} s: "
            f"embed_frames {s['embed'].seconds:.3f} s, train {s['train'].seconds:.3f} s "
            f"({s['step'].calls} steps: {s['step'].ms()}) ({dev['smi']})")
        if s["step"].calls != steps or not 0.0 <= acc <= 1.0:
            raise AssertionError(f"{s['step'].calls} steps, accuracy {acc}")

        # --- 5. train-feature-transformer --data-root over drawn records -------
        frames_of = lipread_records(os.path.join(root, "lrs2"), SEED + 60)
        built = []
        real_build = e2e.build_word_clip_dataset

        def from_memory(*a, **k):     # the card's machine has no OpenCV: frames from memory
            ds = real_build(*a, read_frames=lambda p: (frames_of[p], 25.0), **k)
            built.append(ds)
            return ds

        e2e.build_word_clip_dataset = from_memory
        try:
            text, got = run_cli("train-feature-transformer --data-root", [
                "train-feature-transformer", "--data-root", os.path.join(root, "lrs2"),
                "--max-clips", str(FT_DATA_CLIPS)])
        finally:
            e2e.build_word_clip_dataset = real_build
        n = len(built[0].clips)
        n_val = max(1, int(cfg.val_split * n))
        batch = min(64, n - n_val)
        steps = cfg.num_epochs * ((n - n_val) // batch)
        want = {"clahe": {"packed": FT_DATA_CLIPS, "tiled": 0},
                "small_mha": {"sm90": 0, "cuda_core": cfg.num_layers * (steps + 1)}}
        if got != want:
            raise AssertionError(f"train-feature-transformer --data-root: launches {got}, want "
                                 f"{want}")
        log("features", f"train-feature-transformer --data-root over {FT_DATA_CLIPS} of "
            f"{LR_RECORDS} drawn LRS2-style records ({LR_FRAMES} frames of {LR_HW}x{LR_HW}, from "
            f"memory): {n} word clips, {len(built[0].vocab)} words, {n_val} held out, batch "
            f"{batch}: {steps} steps; K1 {FT_DATA_CLIPS} by packed (one a record), K2 "
            f"{cfg.num_layers * (steps + 1)} by cuda_core, as derived; wall "
            f"{walls['train-feature-transformer --data-root']:.3f} s; "
            + text.strip().splitlines()[-1])
    finally:
        work.cleanup()
    log("features", "stage wall times: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; phase took {time.perf_counter() - phase_t0:.1f} s")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# [parallel]: the multi-GPU story on the one card: a torchrun process group of
# one under NCCL, and two gloo ranks sharing the card

PAR_BATCH = 8            # global batch of the data-parallel diffusion steps: 4 a rank
# float32 data-parallel step (2 ranks, 4 rows each) against one process on the
# 8 rows, the same t, noise and dropout masks: the reduced gradient (relative
# L2 of the whole vector) differs by the order of summation only (the mean
# over the ranks' halves, conv algorithms at batch 4); the planted fault (one
# rank's gradient × 1.01 before the reduction) moves it by 0.005 of that
# rank's half-batch gradient, ~3e-3 of the whole
TOL_PAR_GRAD = 1e-4
TOL_PAR_LOSS = 1e-5      # float32 loss, relative
# bf16 at the defaults, two steps: the first loss (bf16 convs at batch 4 and
# 8 round at other points) within 2e-2 relative, and no parameter more than
# 4·lr from one process's (each of Adam's first two steps moves a weight by
# at most ~lr)
TOL_PAR_LOSS_BF16 = 2e-2
# and the first reduced gradient (relative L2 of the whole vector) against
# one process's: bf16 rounds the activation gradients at batch 4 and 8 at
# other points (read 1.19e-3 on an H100 80GB HBM3 at 700 W); the gate sits
# at about twice that and half the float32 planted fault's reading (4.98e-3)
TOL_PAR_GRAD_BF16 = 2.5e-3
TOL_RING = 1e-4          # float32 ring vs attention_reference, of each tensor's largest
TOL_PP = 1e-4            # float32 pipelined ViViT: logits abs, each gradient leaf rel. L2
PAR_FAULT = 1.01


def _worst(values) -> float:
    """The largest of ``values``, NaN if any is NaN (``max`` drops a NaN
    that is not first, and a gate must not pass one)."""
    values = [float(v) for v in values]
    return math.nan if any(math.isnan(v) for v in values) else max(values)

PAR_FRAMES = 16          # int8 generate_frames request: 16 frames of 360x640, 8 a rank
RING_SHAPE = (1, 4, 16384, 64)   # the U-Net's attention at 128x128, one head of 64 x 4


def _par_counts() -> dict:
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    return {"clahe": cl.clahe_cuda.launch_count, **_counts(),
            "int8_matmul": mm.int8_matmul.launch_count}


def _par_begin() -> torch.device:
    """A check's start on a rank: full float32 (no TF32), deterministic
    algorithms (two runs compared bit for bit must not differ by atomics),
    every launch count and the gloo transport's counters at 0."""
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    _zero_counts()
    pmesh.transport_stats.reset()
    return torch.device("cuda", torch.cuda.current_device())


def _par_end(out: dict) -> dict:
    """``out`` with this rank's launches, backend and gloo transport."""
    import torch.distributed as dist

    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh

    t = pmesh.transport_stats
    out.update(counts=_par_counts(), flash_variants=_flash_variants(),
               backend=dist.get_backend() if dist.is_initialized() else None,
               transport_s=t.seconds, transport_calls=t.calls, transport_bytes=t.bytes)
    return out


def _digest(params) -> str:
    """sha256 of a module's (or a ``state_dict``'s) tensors."""
    sd = params.state_dict() if hasattr(params, "state_dict") else params
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _parallel_tasks():
    """``tests/torch_parallel_tasks.py``: ``LocalGroup`` and the
    data-parallel diffusion driver the CPU tests also run (the two gloo
    ranks import it from the same path)."""
    tests_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    import torch_parallel_tasks

    return torch_parallel_tasks


def _par_batches(cfg_kw: dict, steps: int) -> list:
    """The global batches of the data-parallel diffusion check (every rank
    gets the same feed)."""
    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig

    return [train_batch(DiffusionConfig(**cfg_kw), PAR_BATCH, SEED + 90 + i)
            for i in range(steps)]


# the U-Net's leaves whose gradients pass the ReLU on the audio projection
# (``UNetAudio.encode_condition``): a pre-activation within rounding of 0 opens or
# shuts its gate, so two bf16 runs that round apart there differ on these leaves
# by whole gate elements, not by rounding
AUDIO_GATED = ("audio_encoder.", "audio_proj.")


def _par_diffusion(cfg_kw: dict, steps: int, mesh_kw, device, fault: bool = False,
                   fault_leaf=None, params_file=None) -> dict:
    """``steps`` diffusion steps from seed 0 on ``_par_batches``,
    data-parallel (and tensor-parallel, as ``mesh_kw`` says) over
    ``build_mesh(MeshConfig(**mesh_kw))`` (None: one process), through the
    CPU tests' ``diffusion_dp``: the first step's (reduced) gradient as one
    vector (``grads``; ``grads_ungated``: the leaves outside
    ``AUDIO_GATED``; ``last_grads`` likewise for the last step), the losses,
    step times and params (whole), the bytes of params, EMA and moments
    held. ``fault``: rank 1 scales its gradient (of ``fault_leaf`` only, a
    name or names, when given) by ``PAR_FAULT`` before the reduction.
    ``params_file``: the params to start from (``_tp_params``; default the
    seeded init)."""
    params = None if params_file is None else torch.load(params_file, weights_only=True)
    run = _parallel_tasks().diffusion_dp(cfg_kw, params, _par_batches(cfg_kw, steps), None,
                                         mesh_kw, device=device, seed=SEED,
                                         fault=PAR_FAULT if fault else None,
                                         fault_leaf=fault_leaf)
    for k in ("grads", "last_grads"):
        if k in run:
            grads = run[k]
            run[k] = torch.cat([g.reshape(-1).float() for g in grads.values()])
            run[k + "_ungated"] = torch.cat([g.reshape(-1).float() for n, g in grads.items()
                                             if not n.startswith(AUDIO_GATED)])
    return run


def _par_diffusion_task(cfg_kw: dict, steps: int, mesh_kw: dict, fault: bool,
                        ref_file: str, fault_leaf=None, params_file=None) -> dict:
    """A rank of the two-rank diffusion check: its params' digest, losses,
    step times, and against one process's run (``ref_file``) the relative
    L2 of the first (and the last) step's gradient, of all leaves and of
    the ungated ones, and the params' largest difference; where the
    reference holds ``truth`` (the float32 gradient of the same params and
    batch), the first gradient's relative L2 from it; the tensor-parallel
    leaves and the bytes this rank holds."""
    device = _par_begin()
    run = _par_diffusion(cfg_kw, steps, mesh_kw, device, fault, fault_leaf, params_file)
    ref = torch.load(ref_file, weights_only=True)

    def rel(key):
        if key not in ref or key not in run:
            return None
        g, rg = run[key], ref[key].to(device)
        return float((g - rg).norm() / rg.norm())

    out = {"digest": _digest(run["params"]), "losses": run["losses"], "step_ms": run["step_ms"],
           **{f"{key}_rel": rel(key) for key in ("grads", "grads_ungated", "last_grads",
                                                 "last_grads_ungated")},
           "truth_rel": [float((run[k] - ref[f"truth{x}"].to(device)).norm()
                               / ref[f"truth{x}"].norm())
                         for k, x in (("grads", ""), ("grads_ungated", "_ungated"))
                         if f"truth{x}" in ref],
           "param_max": _worst((v.float() - ref["params"][k].to(device).float()).abs().max()
                               for k, v in run["params"].items()),
           "moments_sharded": run["shards"], "tp": run["tp"], "bytes": run["bytes"],
           "step_transport_s": run["step_transport_s"]}
    return _par_end(out)


def _par_generate_task(ref_file: str) -> dict:
    """A rank of the int8 generate_frames check: its frames against one
    process's."""
    from lipreading_video_generation_tpu_torch.core.config import GanConfig, PreprocessConfig
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh
    from lipreading_video_generation_tpu_torch.pipelines import inference

    device = _par_begin()
    gen = seeded(lambda: TalkingFaceGenerator(width=1.0), SEED).state_dict()
    frames, boxes, mels = lipsync_inputs(PAR_FRAMES, SEED + 96)
    got = inference.generate_frames(gen, frames, boxes, mels, GanConfig(serve_int8=True),
                                    PreprocessConfig(), 1.0, mesh_spec=pmesh.build_mesh(),
                                    device=device)
    want = np.load(ref_file)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return _par_end({"max_diff": int(d.max()), "equal_share": float((d == 0).mean()),
                     "shape": got.shape})


def _ring_inputs(device):
    g = torch.Generator(device=device).manual_seed(SEED + 97)
    return [torch.randn(RING_SHAPE, generator=g, device=device) for _ in range(4)]


def _par_ring_task(ref_file: str) -> dict:
    """A rank of the ring check: forward and backward over 2 ranks of the
    model axis, plain and causal, against ``attention_reference``."""
    from lipreading_video_generation_tpu_torch.core.config import MeshConfig
    from lipreading_video_generation_tpu_torch.ops.ring_attention import ring_attention
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh

    device = _par_begin()
    spec = pmesh.build_mesh(MeshConfig(model_parallel=2))
    ref = torch.load(ref_file, weights_only=True)
    q, k, v, do = _ring_inputs(device)
    out = {}
    for causal in (False, True):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = ring_attention(*leaves, mesh=spec, axis_name="model", causal=causal)
        grads = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = ref["causal" if causal else "plain"]
        errs = [float((a.detach() - w.to(device)).abs().max() / w.abs().max())
                for a, w in zip([o] + list(grads), want)]
        out["causal" if causal else "plain"] = {"err": _worst(errs), "ms": ms}
        del leaves, o, grads
    return _par_end(out)


def _par_vivit_sp_task() -> dict:
    """A rank of the sequence-parallel ViViT check at the defaults (12
    layers, 80 tokens, 40 a rank, bf16): logits through the ring against
    the same model's local attention (K2)."""
    from lipreading_video_generation_tpu_torch.core.config import MeshConfig, ViViTConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh

    device = _par_begin()
    spec = pmesh.build_mesh(MeshConfig(model_parallel=2))
    model = seeded(lambda: ViViT(ViViTConfig(num_classes=8, sequence_parallel=True)),
                   SEED).to(device).eval()
    clips = torch.from_numpy(_vt_batch(PAR_BATCH, SEED + 98)["clips"]).to(device).float() / 255.0
    with torch.no_grad():
        local = model(clips)
        k2 = _par_counts()["small_mha"]
        with pmesh.use_mesh(spec):
            ring = model(clips)
    err = float((ring - local).abs().max())
    rel = float((ring - local).norm() / local.norm())
    return _par_end({"err": err, "rel": rel, "k2_local": k2,
                     "finite": bool(torch.isfinite(ring).all())})


def _par_pp_task(n_micro: int) -> dict:
    """A rank of the pipeline check: the ViViT at its default widths (12
    layers in 2 stages of 6) in float32, ``n_micro`` microbatches of a batch
    of 8: logits and one train step's gradients against the canonical
    model's on the same batch."""
    from lipreading_video_generation_tpu_torch.core.config import MeshConfig, ViViTConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh
    from lipreading_video_generation_tpu_torch.parallel import pipeline as pipe
    from lipreading_video_generation_tpu_torch.pipelines import losses
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

    device = _par_begin()
    spec = pmesh.build_mesh(MeshConfig(model_parallel=2))
    cfg = ViViTConfig(num_classes=8, dtype="float32")
    batch = _vt_batch(PAR_BATCH, SEED + 99)
    clips = torch.from_numpy(batch["clips"]).to(device).float() / 255.0
    labels = torch.from_numpy(batch["labels"]).to(device, torch.long)
    canonical = seeded(lambda: ViViT(cfg), SEED).to(device).eval()
    state = ttv.place_pp_state(spec, ttv.create_state_pp(cfg, SEED, spec, device))
    with torch.no_grad():
        want = canonical(clips)
        got = state.model.eval()(clips, n_micro=n_micro)
    losses.softmax_xent(canonical(clips), labels).backward()
    step, _ = ttv.make_pp_train_step(cfg, spec, n_micro)
    pmesh.run_sharded(spec, step, state, batch)
    layers = pipe.stage_layers(cfg.num_layers, spec)
    canon = dict(canonical.named_parameters())
    worst = 0.0
    for name, p in state.model.named_parameters():
        hit = pipe.split_block_key(name)
        ref = canon[name if hit is None else f"blocks.{layers[hit[0]]}.{hit[1]}"].grad
        worst = _worst([worst, (p.grad - ref).norm() / ref.norm().clamp_min(1e-30)])
    return _par_end({"logit_err": float((got - want).abs().max()), "grad_rel": worst,
                     "stage": [layers.start, layers.stop]})


def _par_serve_request(model, spec, device) -> torch.Tensor:
    """A ViViT request of 8 clips data-parallel over ``spec``: each data
    rank makes the ROIs of its clips' frames (K1), the ROIs are gathered,
    and ``predict_sharded`` runs each rank's rows (K2)."""
    from lipreading_video_generation_tpu_torch.core.config import PreprocessConfig
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv
    from lipreading_video_generation_tpu_torch.pipelines.preprocess import mouth_roi_pipeline

    pre, cfg = PreprocessConfig(), model.cfg
    frames, boxes = request_inputs(PAR_BATCH, SEED + 95)
    rows = (pmesh.padded_rows(spec, PAR_BATCH) if not pmesh.is_degenerate(spec)
            else pmesh.RowShard(PAR_BATCH, 0, PAR_BATCH))
    mine = slice(rows.start * CLIP_FRAMES, (rows.start + rows.count) * CLIP_FRAMES)
    roi = mouth_roi_pipeline(torch.from_numpy(frames[mine]).to(device),
                             torch.from_numpy(boxes[mine]).to(device), pre.lip_crop_size,
                             pre.model_input_size, pre.clahe_clip_limit, pre.clahe_grid)
    if not pmesh.is_degenerate(spec):
        roi = pmesh.all_gather(roi, spec, spec.data_axis)
    clips = roi.reshape(-1, cfg.num_frames, cfg.image_size, cfg.image_size, 1)
    return ttv.predict_sharded(model, clips, mesh_spec=spec)


def _par_serve_task(ref_file: str) -> dict:
    from lipreading_video_generation_tpu_torch.core.config import ViViTConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh

    device = _par_begin()
    model = seeded(lambda: ViViT(ViViTConfig()), SEED).to(device).eval()
    got = _par_serve_request(model, pmesh.build_mesh(), device).cpu()
    want = torch.load(ref_file, weights_only=True)
    return _par_end({"err": float((got - want).abs().max()),
                     "top1": float((got.argmax(-1) == want.argmax(-1)).float().mean())})


# tensor parallelism: the two gloo ranks as one data row of two model ranks
TP2 = {"model_parallel": 2}          # the default threshold, 2^22: the generator's 2 decoder convs
TP2_LOW = {"model_parallel": 2, "model_shard_threshold": 2**16}   # 97.5% of the U-Net's params
TP_FAULT_LEAF = "decoder.layers.1.block.conv.weight"   # a (512, 1024, 3, 3) leaf TP2 shards
# float32 steps on the two model ranks against one process on the same card and
# inputs: the sharded layers' input gradients are sums of two ranks' partial
# products and cuDNN may pick another algorithm for a slice's output channels,
# so they differ by the order of summation (6.5e-7 relative L2 for a small
# U-Net on the CPU); the planted faults (rank 1's gradient of one sharded leaf
# x 1.01) must read above these gates in the same run
TOL_TP_GRAD = 1e-4
TOL_TP_GAN_GRAD = 1e-4
# bf16 U-Net step from drawn params, the first gradient (relative L2) against one
# process's over the leaves outside AUDIO_GATED: the two runs round apart where a
# slice's product sums in another order, and a deep bf16 backward carries that
# (read 2.63e-3 on an H100 80GB HBM3 at 700 W, and both runs 1.2e-2 from the float32
# gradient); behind the audio gate the runs differ by whole gate elements (all
# leaves read 1.77e-2), which the float32 check holds; the gate sits between the
# clean reading and the planted fault's (rank 1's gradients of its slices x 1.01:
# 5.96e-3), about 1.5x from each
TOL_TP_GRAD_BF16 = 4e-3
# the CLI's 2-frame clip at the defaults (bf16, 4 DDIM steps) against one process's PNGs
TOL_TP_CLI_LEVELS = 2
# float generate_frames on two model ranks: within a level of one process's frames
# (the uint8 round of cuDNN's float32 convs), and no more than this share of the
# values off by one (read 0 on an H100 80GB HBM3 at 700 W: the sliced convs give
# one process's bits); the planted fault (rank 1's slice x 1.01) moved 2.64e-5
TOL_TP_FLOAT_LEVELS = 1
TOL_TP_FLOAT_SHARE = 1e-6


def _tp_params(cfg_kw: dict, path: str) -> None:
    """The ``UNetAudio(DiffusionConfig(**cfg_kw))`` params of the
    tensor-parallel diffusion checks, saved at ``path``: the seeded init
    with every >=2-D leaf drawn anew, lecun-normal from seeded numpy (the
    init zeroes ``out_conv``, the residual convs' second conv and the
    attention projections, which would hold every sharded layer's first
    gradient at 0)."""
    from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio

    rng = np.random.default_rng(SEED + 93)
    sd = seeded(lambda: UNetAudio(DiffusionConfig(**cfg_kw)), SEED).state_dict()
    torch.save({k: (torch.from_numpy((rng.standard_normal(tuple(v.shape))
                                      / math.sqrt(v[0].numel())).astype(np.float32))
                    if v.ndim >= 2 else v) for k, v in sd.items()}, path)


def _tp_generate_task(ref_files: dict, fault: bool) -> dict:
    """A rank of ``tp2_generate``: ``generate_frames`` at the defaults on
    two model ranks (the decoder's two 512x1024x3x3 convs column-parallel)
    in int8 and float against one process's frames; K6's launches and
    routes a mode. ``fault``: rank 1's slice of ``TP_FAULT_LEAF`` x
    ``PAR_FAULT`` once placed."""
    import torch.distributed as dist

    from lipreading_video_generation_tpu_torch.core.config import (
        GanConfig, MeshConfig, PreprocessConfig)
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh
    from lipreading_video_generation_tpu_torch.pipelines import inference

    device = _par_begin()
    spec = pmesh.build_mesh(MeshConfig(**TP2))
    gen = seeded(lambda: TalkingFaceGenerator(width=1.0), SEED).state_dict()
    frames, boxes, mels = lipsync_inputs(PAR_FRAMES, SEED + 96)
    tasks = _parallel_tasks()
    real = pmesh.shard_params
    out = {}

    def placed(spec_, module):          # the generator generate_frames builds, placed
        real(spec_, module)
        out["bytes"] = tasks.held_bytes([module], [])
        out["bytes_one"] = tasks.held_bytes([module], [], spec_)
        if fault and dist.get_rank() == 1:
            with torch.no_grad():
                module.get_parameter(TP_FAULT_LEAF).mul_(PAR_FAULT)
        return module

    pmesh.shard_params = placed
    try:
        for mode, gan_cfg in (("int8", GanConfig(serve_int8=True)), ("float", GanConfig())):
            before = (_par_counts()["int8_matmul"], dict(mm.int8_matmul.route_counts))
            got = inference.generate_frames(gen, frames, boxes, mels, gan_cfg,
                                            PreprocessConfig(), 1.0, mesh_spec=spec,
                                            device=device)
            want = np.load(ref_files[mode])
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            out[mode] = {"max_diff": int(d.max()), "equal_share": float((d == 0).mean()),
                         "shape": got.shape,
                         "k6": _par_counts()["int8_matmul"] - before[0],
                         "routes": {k: n - before[1][k]
                                    for k, n in mm.int8_matmul.route_counts.items()}}
    finally:
        pmesh.shard_params = real
    with torch.device("meta"):
        out["leaves"] = pmesh.tensor_parallel_leaves(spec, TalkingFaceGenerator(width=1.0))
    return _par_end(out)


def _tp_gan_train_task(ck_dir: str) -> dict:
    """A rank of ``tp2_gan``: ``train_gan.train`` at the ``GanConfig``
    defaults (bf16, batch 16) for 2 steps on two model ranks at the default
    threshold, a checkpoint at step 2: the digests of this rank's replicated
    leaves and of the whole state, the sharded leaves of each network, the
    step times, the bytes held (params of G, D and SyncNet and both Adam
    states) against one process's."""
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import GanConfig, MeshConfig
    from lipreading_video_generation_tpu_torch.data import datasets
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    device = _par_begin()
    tasks = _parallel_tasks()
    spec = pmesh.build_mesh(MeshConfig(**TP2))
    cfg = dataclasses.replace(GanConfig(), checkpoint_interval=2)
    clips = datasets.synthetic_av_clips(n_clips=8, frames=50, img=cfg.img_size, seed=SEED)
    sampler = datasets.GanWindowSampler(clips, cfg.syncnet_T, seed=SEED)
    marks = []

    class Clock:        # train() writes each step's metrics on the primary rank
        def write(self, step, metrics):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

    t0 = time.perf_counter()
    state = ttg.train(cfg, lambda: sampler.sample_batch(cfg.batch_size), num_steps=2,
                      checkpoint_dir=ck_dir, mesh_spec=spec, device=device,
                      metrics_writer=Clock())
    leaves = {net: pmesh.tensor_parallel_leaves(spec, getattr(state, net))
              for net in ("gen", "disc", "syncnet")}
    replicated = {f"{net}.{k}": v for net in ("gen", "disc")
                  for k, v in getattr(state, net).state_dict().items() if k not in leaves[net]}
    whole = {f"{net}.{k}": v for net in ("gen", "disc")
             for k, v in pmesh.full_state_dict(spec, getattr(state, net)).items()}
    nets, opts = [state.gen, state.disc, state.syncnet], [state.gen_opt, state.disc_opt]
    held, one = tasks.held_bytes(nets, opts), tasks.held_bytes(nets, opts, spec)
    return _par_end({"replicated": _digest(replicated), "whole": _digest(whole),
                     "leaves": leaves, "bytes": held, "bytes_one": one,
                     "step_ms": (marks[1] - marks[0]) * 1e3 if len(marks) > 1 else None,
                     "wall_s": time.perf_counter() - t0, "files": sorted(os.listdir(ck_dir))})


def _tp_gan_step_task(files: dict, fault: bool) -> dict:
    """A rank of ``tp2_gan``'s float32 check: one G+D step at width 1.0,
    batch 2, sync gate open, on two model ranks at the default threshold,
    from the weights and prepared batch one process stepped from
    (``files``); each network's whole gradient against one process's
    (``gan_grad_l2``). ``fault``: rank 1's gradient of its slice of
    ``TP_FAULT_LEAF`` x ``PAR_FAULT`` before the update."""
    import dataclasses

    import torch.distributed as dist

    from lipreading_video_generation_tpu_torch.core.config import GanConfig, MeshConfig
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    device = _par_begin()
    tasks = _parallel_tasks()
    spec = pmesh.build_mesh(MeshConfig(**TP2))
    f32 = dataclasses.replace(GanConfig(), dtype="float32", batch_size=GAN_STEP_BATCH)
    sds = torch.load(files["sds"], weights_only=True)
    prep = torch.load(files["prep"], weights_only=True)
    want = torch.load(files["ref"], weights_only=True)
    state = pmesh.shard_state(spec, _gan_state(f32, sds, device, 0.03))
    if fault and dist.get_rank() == 1:
        opt, reduce = state.gen_opt, state.gen_opt.reduce_gradients
        leaf = state.gen.get_parameter(TP_FAULT_LEAF)

        def faulty():
            leaf.grad.mul_(PAR_FAULT)
            reduce()

        opt.reduce_gradients = faulty
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _prepared(prep):
        ttg.train_step(state, {}, f32)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = {f"{net}.{n}": g.float().cpu() for net in ("gen", "disc")
             for n, g in tasks.whole_grads(spec, getattr(state, net)).items()}
    l2, _ = gan_grad_l2({"grads": grads}, want)
    return _par_end({"grad_l2": l2, "ms": ms,
                     "tp": pmesh.tensor_parallel_leaves(spec, state.gen)})


def _tp_serve_task(ref_file: str) -> dict:
    """A rank of ``tp2_serve``: a ViViT request at the defaults (bf16)
    through ``predict_sharded`` on two model ranks at threshold 2^16: the
    log-probs against one process's, the caller's model before and after."""
    from lipreading_video_generation_tpu_torch.core.config import MeshConfig, ViViTConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh

    device = _par_begin()
    tasks = _parallel_tasks()
    model = seeded(lambda: ViViT(ViViTConfig()), SEED).to(device).eval()
    before = _digest(model)
    spec = pmesh.build_mesh(MeshConfig(**TP2_LOW))
    real, held = pmesh.shard_params, []

    def placed(spec_, module):          # the copy predict_sharded places
        real(spec_, module)
        held.append(tasks.held_bytes([module], []))
        return module

    pmesh.shard_params = placed
    try:
        t0 = time.perf_counter()
        got = _par_serve_request(model, spec, device).cpu()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        pmesh.shard_params = real
    want = torch.load(ref_file, weights_only=True)
    return _par_end({"err": float((got - want).abs().max()),
                     "top1": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
                     "unchanged": _digest(model) == before and not pmesh.is_placed(model),
                     "leaves": len(pmesh.tensor_parallel_leaves(spec, model)), "ms": ms,
                     "bytes": held[-1], "bytes_one": tasks.held_bytes([model], [])})


def _tp_cli_task(out_dir: str) -> dict:
    """A rank of ``tp2_cli``: ``sample-diffusion --frames 2`` at the
    defaults through ``cli.main`` with ``--set mesh.model_parallel=2
    mesh.model_shard_threshold=65536``; rank 1 may write nothing under
    ``out_dir`` (its writes there are recorded)."""
    device = _par_begin()
    with _fresh_process_flags():
        out = _parallel_tasks().cli_main(
            _SAMPLE_ARGV + ["--out", os.path.join(out_dir, "tp.png"), "--set",
                            "mesh.model_parallel=2", "--set", "mesh.model_shard_threshold=65536"],
            watch_root=out_dir, device=str(device))
    return _par_end(out)


def _par_tp(dev: dict, group, work: str) -> tuple:
    """The tensor-parallel cases on the two gloo ranks (see the module's
    docstring): one process's references first, then each case; returns
    (the runs, what this process read), which ``_tp_gates`` holds."""
    import dataclasses

    from lipreading_video_generation_tpu_torch.core.config import AudioConfig, GanConfig
    from lipreading_video_generation_tpu_torch.core.config import PreprocessConfig
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.data import datasets
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator
    from lipreading_video_generation_tpu_torch.pipelines import inference
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    device = _par_begin()
    gen = seeded(lambda: TalkingFaceGenerator(width=1.0), SEED).state_dict()
    frames, boxes, mels = lipsync_inputs(PAR_FRAMES, SEED + 96)
    files = {"int8": os.path.join(work, "frames.npy"),
             "float": os.path.join(work, "frames_float.npy")}
    np.save(files["float"], inference.generate_frames(gen, frames, boxes, mels, GanConfig(),
                                                      PreprocessConfig(), 1.0, device=device))
    base = GanConfig()
    f32 = dataclasses.replace(base, dtype="float32", batch_size=GAN_STEP_BATCH)
    sds = gan_state_dicts(base.model_width, SEED)
    clips = datasets.synthetic_av_clips(n_clips=8, frames=50, img=base.img_size, seed=SEED)
    batch = datasets.GanWindowSampler(clips, base.syncnet_T, seed=SEED).sample_batch(
        GAN_STEP_BATCH)
    prep = ttg.prepare_batch(batch, f32, AudioConfig(), "cpu")
    want = gan_step_capture(f32, sds, prep, device, 0.03)
    gan_files = {k: os.path.join(work, f"gan_{k}.pt") for k in ("sds", "prep", "ref")}
    torch.save(sds, gan_files["sds"])
    torch.save(prep, gan_files["prep"])
    torch.save({"grads": want["grads"], "zero": sorted(want["zero"])}, gan_files["ref"])
    del want, sds
    # the U-Net checks from drawn params (the seeded init zeroes out_conv, so at
    # step 1 no gradient would reach a sharded layer): one process's runs, saved
    diff = {"bf16": ({}, 2), "f32": ({"im_size": 64, "dtype": "float32"}, 1)}
    diff_one = {}
    for name, (kw, steps) in diff.items():
        pfile, ref = (os.path.join(work, f"tp_unet_{name}{x}.pt") for x in ("", "_ref"))
        _tp_params(kw, pfile)
        run = _par_diffusion(kw, steps, None, device, params_file=pfile)
        keys = [k + x for k in ("grads", "last_grads") for x in ("", "_ungated") if k + x in run]
        saved = {k: run[k].cpu() for k in keys}
        saved["params"] = {k: v.cpu() for k, v in run["params"].items()}
        diff_one[name] = {"pfile": pfile, "ref": ref, "losses": run["losses"],
                          "step_ms": run["step_ms"], "bytes": run["bytes"]}
        del run
        torch.cuda.empty_cache()
        if kw.get("dtype", "bfloat16") != "float32":
            # the float32 gradient of the same params and batch: how far bf16 is from it
            truth = _par_diffusion(dict(kw, dtype="float32"), 1, None, device,
                                   params_file=pfile)
            diff_one[name]["truth_rel"] = []
            for x in ("", "_ungated"):
                saved["truth" + x] = t = truth["grads" + x].cpu()
                diff_one[name]["truth_rel"].append(float((saved["grads" + x] - t).norm()
                                                         / t.norm()))
            del truth
            torch.cuda.empty_cache()
        torch.save(saved, ref)
    ck = os.path.join(work, "tp_gan_ck")
    cli_dir = os.path.join(work, "tp_cli")
    os.makedirs(cli_dir)
    runs = {
        "tp2_generate": group.run(_tp_generate_task, files, False),
        "tp2_generate_fault": group.run(_tp_generate_task, files, True),
        "tp2_gan": group.run(_tp_gan_train_task, ck),
        "tp2_gan_f32": group.run(_tp_gan_step_task, gan_files, False),
        "tp2_gan_f32_fault": group.run(_tp_gan_step_task, gan_files, True),
    }
    for name, (kw, steps) in diff.items():
        one_run = diff_one[name]
        clean = group.run(_par_diffusion_task, kw, steps, TP2_LOW, False, one_run["ref"], None,
                          one_run["pfile"])
        runs[f"tp2_diffusion_{name}"] = clean
        # the planted fault: rank 1's gradients of its slices x 1.01 at every step
        runs[f"tp2_diffusion_{name}_fault"] = group.run(
            _par_diffusion_task, kw, 1, TP2_LOW, True, one_run["ref"],
            sorted(clean[0]["tp"]), one_run["pfile"])
    runs["tp2_serve"] = group.run(_tp_serve_task, os.path.join(work, "serve.pt"))
    runs["tp2_cli"] = group.run(_tp_cli_task, cli_dir)
    ckpt = torch.load(os.path.join(ck, "step_2.pt"), map_location="cpu", weights_only=True)
    one = {"diffusion": diff_one, "ckpt": ckpt, "ckpt_files": sorted(os.listdir(ck)),
           "cli_files": sorted(os.listdir(cli_dir)),
           "cli_frames": [read_png(os.path.join(cli_dir, f"tp.png.{j:04d}.png"))
                          for j in range(2)],
           "none_frames": [read_png(os.path.join(work, f"none.png.{j:04d}.png"))
                           for j in range(2)]}
    return runs, one


def _tp_gates(dev: dict, runs: dict, one: dict) -> None:
    """Hold the tensor-parallel cases against one process's runs and print
    them: each case's readings are printed first, then every gate is held
    (``not (x <= tol)``, NaN-safe), each below a planted fault's reading in
    the same run."""
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator

    fails = []

    def gate(ok: bool, what: str) -> None:
        if not ok:
            fails.append(what)

    # tp2_generate
    gen, fault = runs["tp2_generate"], runs["tp2_generate_fault"]
    i8 = _worst(r["int8"]["max_diff"] for r in gen)
    fl = _worst(r["float"]["max_diff"] for r in gen)
    fl_share = _worst(1.0 - r["float"]["equal_share"] for r in gen)
    i8_fault = _worst(r["int8"]["max_diff"] for r in fault)
    fl_fault = _worst(r["float"]["max_diff"] for r in fault)
    fl_fault_share = _worst(1.0 - r["float"]["equal_share"] for r in fault)
    want_leaves = {"decoder.layers.1.block.conv.weight": 0,
                   "decoder.layers.3.block.conv.weight": 0}
    log("parallel", f"tp2_generate: generate_frames at the GanConfig defaults, width 1.0, "
        f"{PAR_FRAMES} frames of 360x640 on 2 model ranks at the default threshold (sharded: "
        f"{sorted(gen[0]['leaves'])}): int8 frames {i8} levels from one process's (gate 0); "
        f"float {fl} levels (gate {TOL_TP_FLOAT_LEVELS}), {fl_share:.3g} of the values differ "
        f"(gate {TOL_TP_FLOAT_SHARE}); planted fault, rank 1's slice of {TP_FAULT_LEAF} x "
        f"{PAR_FAULT}: int8 {i8_fault} levels, float {fl_fault} levels with {fl_fault_share:.3g} "
        f"of the values off; K6 a rank {gen[0]['int8']['k6']} in int8, routes a rank "
        f"{[r['int8']['routes'] for r in gen]}; params a rank {gen[0]['bytes'] / 1e6:.1f} MB of "
        f"one process's {gen[0]['bytes_one'] / 1e6:.1f} MB "
        f"({gen[0]['bytes'] / gen[0]['bytes_one']:.3f}x)")
    gate(i8 <= 0 and fl <= TOL_TP_FLOAT_LEVELS and fl_share <= TOL_TP_FLOAT_SHARE,
         f"tp2 generate_frames: int8 {i8} levels, float {fl} levels / {fl_share:.3g} of the "
         "values from one process's")
    gate(gen[0]["leaves"] == want_leaves, f"tp2 generate_frames: sharded {gen[0]['leaves']}")
    gate(i8_fault > 0 and fl_fault_share > TOL_TP_FLOAT_SHARE,
         f"tp2 generate_frames: the planted fault read int8 {i8_fault} levels, float "
         f"{fl_fault_share:.3g} of the values: not above the gates")
    gate(all(r["int8"]["k6"] == 51 and r["float"]["k6"] == 0 for r in gen),
         f"tp2 generate_frames: K6 {[(r['int8']['k6'], r['float']['k6']) for r in gen]} a "
         "rank, want 51 (int8) and 0 (float)")
    # tp2_gan
    gan = runs["tp2_gan"]
    with torch.device("meta"):
        names = [n for n, _ in TalkingFaceGenerator(width=1.0).named_parameters()]
    ck = one["ckpt"]
    whole = (512, 1024, 3, 3)
    shapes = {}
    for n in want_leaves:
        st = ck["gen_opt"]["state"].get(names.index(n), {})
        shapes[n] = (tuple(ck["gen"][n].shape), tuple(st.get("exp_avg", torch.zeros(0)).shape),
                     tuple(st.get("exp_avg_sq", torch.zeros(0)).shape))
    f32, f32_fault = runs["tp2_gan_f32"], runs["tp2_gan_f32_fault"]
    g_gen = _worst(r["grad_l2"]["gen"] for r in f32)
    g_disc = _worst(r["grad_l2"]["disc"] for r in f32)
    g_fault = _worst(r["grad_l2"]["gen"] for r in f32_fault)
    step_ms = gan[0]["step_ms"]
    log("parallel", f"tp2_gan: train_gan.train at the GanConfig defaults (bf16, batch 16) on 2 "
        f"model ranks, default threshold, 2 steps: the ranks' whole params "
        f"{'equal' if len({r['whole'] for r in gan}) == 1 else 'DIFFER'}, their replicated "
        f"leaves {'equal' if len({r['replicated'] for r in gan}) == 1 else 'DIFFER'}; "
        f"checkpoint files {one['ckpt_files']}, the sharded leaves and their Adam moments "
        f"there {shapes}; step 2 took {step_ms} ms on the primary (train() "
        f"{max(r['wall_s'] for r in gan):.1f} s in all); float32 step at width 1.0, batch 2, "
        f"sync gate open: whole gradients gen {g_gen:.3g}, disc {g_disc:.3g} relative L2 from "
        f"one process's (gate {TOL_TP_GAN_GRAD}), {max(r['ms'] for r in f32):.1f} ms a rank; "
        f"planted fault, rank 1's gradient of its slice of {TP_FAULT_LEAF} x {PAR_FAULT}: gen "
        f"{g_fault:.3g}; params + Adam moments a rank {gan[0]['bytes'] / 1e6:.1f} MB of one "
        f"process's {gan[0]['bytes_one'] / 1e6:.1f} MB "
        f"({gan[0]['bytes'] / gan[0]['bytes_one']:.3f}x)")
    gate(len({r["replicated"] for r in gan}) == 1 and len({r["whole"] for r in gan}) == 1,
         "tp2 train_gan: the ranks' replicated leaves or whole params differ")
    gate(gan[0]["leaves"]["gen"] == want_leaves and not gan[0]["leaves"]["disc"]
         and not gan[0]["leaves"]["syncnet"], f"tp2 train_gan: sharded {gan[0]['leaves']}")
    gate(all(v == (whole,) * 3 for v in shapes.values()) and one["ckpt_files"] == ["step_2.pt"]
         and ck["step"] == 2 and step_ms is not None,
         f"tp2 train_gan checkpoint: {one['ckpt_files']}, {shapes}")
    gate(g_gen <= TOL_TP_GAN_GRAD and g_disc <= TOL_TP_GAN_GRAD,
         f"tp2 GAN float32 step: gradients gen {g_gen:.3g}, disc {g_disc:.3g}")
    gate(g_fault > TOL_TP_GAN_GRAD, f"tp2 GAN: the planted fault read {g_fault:.3g}")
    # tp2_diffusion
    bf, bff = runs["tp2_diffusion_bf16"], runs["tp2_diffusion_bf16_fault"]
    f, ff = runs["tp2_diffusion_f32"], runs["tp2_diffusion_f32_fault"]
    one_bf, one_f = one["diffusion"]["bf16"], one["diffusion"]["f32"]
    loss_bf = abs(bf[0]["losses"][0] - one_bf["losses"][0]) / abs(one_bf["losses"][0])
    loss_f = abs(f[0]["losses"][0] - one_f["losses"][0]) / abs(one_f["losses"][0])
    g_bf = _worst(r["grads_ungated_rel"] for r in bf)
    g_bff = _worst(r["grads_ungated_rel"] for r in bff)
    g_f, g_ff = _worst(r["grads_rel"] for r in f), _worst(r["grads_rel"] for r in ff)
    share = _worst(r["step_transport_s"] / (sum(r["step_ms"]) / 1e3) for r in bf)
    pmax = _worst(r["param_max"] for r in bf)

    def rels(key):
        return [round(r[key], 7) for r in bf]
    log("parallel", f"tp2_diffusion: DiffusionConfig defaults on 2 model ranks at threshold "
        f"2^16 ({len(bf[0]['tp'])} leaves sharded), from drawn params: bf16, global batch "
        f"{PAR_BATCH}, 2 steps: ranks {'equal' if len({r['digest'] for r in bf}) == 1 else 'DIFFER'}"
        f", first loss {loss_bf:.3g} relative; against one process's gradients (relative L2), "
        f"step 1: the leaves outside {AUDIO_GATED} {rels('grads_ungated_rel')} (gate "
        f"{TOL_TP_GRAD_BF16}), all leaves {rels('grads_rel')}; step 2: "
        f"{rels('last_grads_ungated_rel')}, all {rels('last_grads_rel')}; planted fault (rank 1's "
        f"gradients of its slices x {PAR_FAULT}) {g_bff:.4g} outside, "
        f"{_worst(r['grads_rel'] for r in bff):.4g} all; against the float32 gradient of the same "
        f"params and batch (all leaves, outside): one process {one_bf['truth_rel']}, two model "
        f"ranks {bf[0]['truth_rel']}, the fault {bff[0]['truth_rel']}; params after 2 steps at "
        f"most {pmax:.3g} apart; step times {[round(t, 1) for t in bf[0]['step_ms']]} ms a rank "
        f"against one process's {[round(t, 1) for t in one_bf['step_ms']]} ms, gloo transport "
        f"{share:.1%} of them; float32 at 64x64: gradient {g_f:.3g} (gate {TOL_TP_GRAD}), loss "
        f"{loss_f:.3g}, planted fault {g_ff:.3g}; params + EMA + Adam moments a rank "
        f"{bf[0]['bytes'] / 1e6:.1f} MB of one process's {one_bf['bytes'] / 1e6:.1f} MB "
        f"({bf[0]['bytes'] / one_bf['bytes']:.3f}x) on {dev['smi']}")
    gate(len({r["digest"] for r in bf}) == 1 and len({r["digest"] for r in f}) == 1,
         "tp2 diffusion: the ranks' whole params differ")
    for i, r in enumerate(f + ff):   # float32: K3/K4/K5 by the tiled kernels on both model ranks
        _flash_tiled("parallel", f"tp2 float32 diffusion step, model rank {i % 2}",
                     {k: {v: n for v, n in c.items() if n} for k, c in r["flash_variants"].items()})
    want_k = {"flash_attention": 32, "flash_bwd_dkv": 32, "flash_bwd_dq": 32, "small_mha": 8}
    gate(all(r["counts"][k] == n for r in bf for k, n in want_k.items()),
         f"tp2 bf16 diffusion launches {[r['counts'] for r in bf]}, want {want_k} a rank")
    gate(loss_bf <= TOL_PAR_LOSS_BF16 and g_bf <= TOL_TP_GRAD_BF16,
         f"tp2 bf16 diffusion: loss {loss_bf:.3g}, gradient {g_bf:.3g}")
    gate(g_bff > TOL_TP_GRAD_BF16, f"tp2 bf16 diffusion: the planted fault read {g_bff:.3g}")
    gate(g_f <= TOL_TP_GRAD and loss_f <= TOL_PAR_LOSS,
         f"tp2 float32 diffusion: gradient {g_f:.3g}, loss {loss_f:.3g}")
    gate(g_ff > TOL_TP_GRAD, f"tp2 float32 diffusion: the planted fault read {g_ff:.3g}")
    # tp2_serve
    serve = runs["tp2_serve"]
    err = _worst(r["err"] for r in serve)
    log("parallel", f"tp2_serve: ViViT request of {PAR_BATCH} clips at the defaults (bf16) on 2 "
        f"model ranks at threshold 2^16 ({serve[0]['leaves']} leaves sharded in a placed copy; "
        f"the caller's model unchanged: {[r['unchanged'] for r in serve]}): log-probs "
        f"{err:.3g} from one process's (gate {TOL_LOGITS}), top-1 agreement "
        f"{min(r['top1'] for r in serve):.4f}, {max(r['ms'] for r in serve):.1f} ms; launches a "
        f"rank {[r['counts'] for r in serve]}; params a rank {serve[0]['bytes'] / 1e6:.1f} MB of "
        f"{serve[0]['bytes_one'] / 1e6:.1f} MB ({serve[0]['bytes'] / serve[0]['bytes_one']:.3f}x)")
    gate(err <= TOL_LOGITS and all(r["unchanged"] for r in serve),
         f"tp2 predict_sharded: log-probs {err:.3g}, unchanged {[r['unchanged'] for r in serve]}")
    gate(all(r["counts"]["clahe"] == 1 and r["counts"]["small_mha"] == 12 for r in serve),
         f"tp2 predict_sharded launches {[r['counts'] for r in serve]}, want K1 1, K2 12")
    # tp2_cli
    cli = runs["tp2_cli"]
    want_files = ["tp.png.0000.png", "tp.png.0001.png"]
    levels = _worst(np.abs(a.astype(int) - b.astype(int)).max()
                    for a, b in zip(one["cli_frames"], one["none_frames"]))
    log("parallel", f"tp2_cli: cli.main sample-diffusion --frames 2 at the defaults with "
        f"mesh.model_parallel=2, model_shard_threshold=65536 in each rank: exit codes "
        f"{[r['rc'] for r in cli]}, files {one['cli_files']} (rank 1 wrote {cli[1]['wrote']}), "
        f"{levels} levels from one process's PNGs (gate {TOL_TP_CLI_LEVELS}); launches a rank "
        f"{[r['counts'] for r in cli]}")
    gate([(r["rc"], r["wrote"]) for r in cli] == [(0, [])] * 2 and one["cli_files"] == want_files,
         f"tp2 sample-diffusion: exit codes {[r['rc'] for r in cli]}, files {one['cli_files']}")
    gate(levels <= TOL_TP_CLI_LEVELS, f"tp2 sample-diffusion: frames {levels} levels apart")
    if fails:
        raise AssertionError("tensor parallelism: " + "; ".join(fails))


def _torchrun(argv: list) -> subprocess.Popen:
    """Start ``argv`` of the port's CLI under ``python -m
    torch.distributed.run --standalone --nproc-per-node 1``; ``_finished``
    waits for it."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "lipreading_video_generation_tpu_torch.cli"] + argv
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _finished(proc: subprocess.Popen, what: str, timeout: float = 400) -> str:
    """The standard output of a ``_torchrun`` process once it has ended;
    raises when it fails or runs past ``timeout``."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"torchrun {what}: no end within {timeout} s") from None
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {what} exited {proc.returncode}:\n{out[-3000:]}\n"
                             f"{err[-3000:]}")
    return out


@contextlib.contextmanager
def _fresh_process_flags():
    """The matmul and convolution flags of a freshly started process (what
    a ``python -m ...cli`` run has), for in-process runs held against one."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = FRESH_TF32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _cli_in_process(argv: list) -> str:
    from lipreading_video_generation_tpu_torch import cli

    out = io.StringIO()
    with _fresh_process_flags(), contextlib.redirect_stdout(out):
        if cli.main(argv) != 0:
            raise AssertionError(f"cli.main({argv[0]}) failed")
    return out.getvalue()


_VIVIT_ARGV = ["train-vivit", "--synthetic", "--steps", "32", "--set", "vivit.num_classes=8"]
_SAMPLE_ARGV = ["sample-diffusion", "--frames", "2", "--ddim-steps", "4"]


def _par_launch(work: str) -> dict:
    """Start ``train-vivit`` and ``sample-diffusion`` at the defaults under
    torchrun (world size 1, NCCL): the launcher check's processes, which
    run while this process does its own work."""
    return {"t0": time.perf_counter(), "vivit": _torchrun(_VIVIT_ARGV),
            "sample": _torchrun(_SAMPLE_ARGV + ["--out", os.path.join(work, "nccl.png")])}


def _par_launcher(dev: dict, work: str, launched: dict) -> None:
    """World size 1 under NCCL through the real launcher: the torchrun
    processes of ``_par_launch`` against the same commands run in this
    process without a process group (mesh_spec=None's path)."""
    here = [line for line in _cli_in_process(_VIVIT_ARGV).splitlines()
            if line.startswith("best:")]
    _cli_in_process(_SAMPLE_ARGV + ["--out", os.path.join(work, "none.png")])
    out = _finished(launched["vivit"], "train-vivit")
    _finished(launched["sample"], "sample-diffusion")
    launch_s = time.perf_counter() - launched["t0"]
    if "backend nccl, world size 1" not in out:
        raise AssertionError(f"torchrun train-vivit did not run on a NCCL group:\n{out}")
    best = [line for line in out.splitlines() if line.startswith("best:")]
    if not best or best != here:
        raise AssertionError(f"train-vivit: torchrun {best} != in process {here}")
    for j in range(2):
        a, b = (open(os.path.join(work, f"{n}.png.{j:04d}.png"), "rb").read()
                for n in ("nccl", "none"))
        if a != b:
            raise AssertionError(f"sample-diffusion frame {j}: torchrun's PNG differs")
    log("parallel", f"torchrun --nproc-per-node 1 (backend nccl, world size 1): train-vivit 32 "
        f"steps at the ViViTConfig defaults gives the in-process run's {best[0]!r}; "
        f"sample-diffusion --frames 2 --ddim-steps 4 at the DiffusionConfig defaults writes the "
        f"same PNG bytes (both launches, beside this process's runs, {launch_s:.1f} s) on "
        f"{dev['smi']}")


def _par_in_process(dev: dict, work: str) -> dict:
    """A NCCL process group of one in this process: each mesh entry point
    with ``build_mesh()`` against ``mesh_spec=None``, bit for bit."""
    import torch.distributed as dist

    from lipreading_video_generation_tpu_torch.core.config import (
        DiffusionConfig, GanConfig, PreprocessConfig, SuperResConfig, ViViTConfig, Config)
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.data import datasets
    from lipreading_video_generation_tpu_torch.data.loader import prefetch_to_device
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.parallel import distributed
    from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh
    from lipreading_video_generation_tpu_torch.pipelines import (
        inference, sample_diffusion, train_diffusion, train_gan, train_superres, train_vivit)

    device = torch.device("cuda", 0)
    d = DiffusionConfig(batch_size=4)
    unet = seeded(lambda: UNetAudio(d), SEED).to(device).eval()
    rng = np.random.default_rng(SEED + 100)
    cond = rng.integers(0, 256, (d.im_size, d.im_size, 3), dtype=np.uint8)
    audio = rng.standard_normal((3, d.audio_samples)).astype(np.float32)
    vivit = seeded(lambda: ViViT(ViViTConfig()), SEED).to(device).eval()
    gen = seeded(lambda: TalkingFaceGenerator(width=1.0), SEED).state_dict()
    frames, boxes, mels = lipsync_inputs(8, SEED + 101)
    gan_cfg = GanConfig(batch_size=4)
    gan_clips = datasets.synthetic_gan_clips(n_clips=2, frames=20)
    sr = SuperResConfig(batch_size=2)

    def feed(n, make):
        items = iter([make(i) for i in range(n)])
        return lambda: next(items, None)

    def entry_points(spec) -> dict:
        out = {"predict_sharded": _par_serve_request(vivit, spec, device).cpu(),
               "generate_frames_int8": inference.generate_frames(
                   gen, frames, boxes, mels, GanConfig(serve_int8=True), PreprocessConfig(),
                   1.0, mesh_spec=spec, device=device),
               "sample_video": sample_diffusion.sample_video(
                   unet, cond, audio, d, num_inference_steps=3, mesh_spec=spec,
                   generator=torch.Generator(device).manual_seed(SEED)).cpu()}
        st = train_diffusion.train(d, feed(2, lambda i: train_batch(d, 4, SEED + 102 + i)),
                                   num_steps=2, mesh_spec=spec, device=device)
        out["train_diffusion"] = _digest(st.model)
        vcfg = Config(vivit=ViViTConfig(num_classes=8))
        st, _ = train_vivit.train(vcfg, lambda: iter([_vt_batch(16, SEED + 104 + i)
                                                      for i in range(2)]),
                                  num_epochs=1, mesh_spec=spec, device=device)
        out["train_vivit"] = _digest(st.model)
        sampler = datasets.GanWindowSampler(gan_clips, seed=SEED)
        st = train_gan.train(gan_cfg, lambda: sampler.sample_batch(4), num_steps=1,
                             mesh_spec=spec, device=device)
        out["train_gan"] = _digest(st.gen) + _digest(st.disc)
        st = train_superres.train(sr, feed(1, lambda i: {"target_frame": train_batch(
            d, 2, SEED + 106)["target_frame"]}), num_steps=1, mesh_spec=spec, device=device)
        out["train_superres"] = _digest(st.model)
        fed = list(prefetch_to_device(feed(2, lambda i: train_batch(d, 4, SEED + 107 + i)),
                                      spec=spec, device=device))
        out["prefetch_to_device"] = [t.cpu() for b in fed for t in b.values()]
        return out

    t0 = time.perf_counter()
    want = entry_points(None)
    none_s = time.perf_counter() - t0
    distributed.initialize(rank=0, world_size=1,
                           store=dist.FileStore(os.path.join(work, "nccl_store"), 1))
    try:
        spec = pmesh.build_mesh()
        backend = dist.get_backend()
        if backend != "nccl" or pmesh.is_degenerate(spec):
            raise AssertionError(f"in-process group: backend {backend}, mesh {spec}")
        t0 = time.perf_counter()
        got = entry_points(spec)
        mesh_s = time.perf_counter() - t0
    finally:
        distributed.shutdown()
    for name, w in want.items():
        g = got[name]
        same = (all(torch.equal(a, b) for a, b in zip(g, w)) if isinstance(w, list)
                else torch.equal(g, w) if isinstance(w, torch.Tensor)
                else np.array_equal(g, w) if isinstance(w, np.ndarray) else g == w)
        if not same:
            raise AssertionError(f"{name}: build_mesh() under NCCL (world size 1) differs from "
                                 "mesh_spec=None")
    log("parallel", f"NCCL process group of one in this process (backend {backend}): "
        f"{', '.join(want)} through build_mesh() equal mesh_spec=None bit for bit "
        f"({none_s:.1f} s without the mesh, {mesh_s:.1f} s with it) on {dev['smi']}")
    return {}


def phase_parallel(dev: dict) -> dict:
    """[parallel]: see the module's docstring."""
    import tempfile

    from lipreading_video_generation_tpu_torch.core.config import (
        GanConfig, PreprocessConfig, ViViTConfig)
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.ops.attention import attention_reference
    from lipreading_video_generation_tpu_torch.pipelines import inference

    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_")
    launches = dict.fromkeys(("clahe", "small_mha", "flash_attention", "flash_bwd_dkv",
                              "flash_bwd_dq", "int8_matmul"), 0)
    launched, group = {}, None
    try:
        # the torchrun processes and the two gloo ranks start while this
        # process runs the launcher's references and the NCCL group of one
        launched = _par_launch(work.name)
        group = _parallel_tasks().LocalGroup(2, os.path.join(work.name, "gloo_store"),
                                             device="cuda:0", backend="gloo")
        _par_launcher(dev, work.name, launched)
        _par_begin()
        _par_in_process(dev, work.name)
        for k, n in _par_counts().items():
            launches[k] += n
        group.run(_par_begin)       # both ranks up before one process's timed references
        # one process's references for the two-rank checks
        device = _par_begin()
        bf16, f32 = {}, {"im_size": 64, "dtype": "float32"}
        refs = {}
        for name, cfg_kw, steps in (("bf16", bf16, 2), ("f32", f32, 1)):
            run = _par_diffusion(cfg_kw, steps, None, device)
            refs[name] = run
            path = os.path.join(work.name, f"diffusion_{name}.pt")
            torch.save({"grads": run["grads"].cpu(),
                        "params": {k: v.cpu() for k, v in run["params"].items()}}, path)
            run["file"] = path
            del run["params"], run["ema"], run["grads"]
            run.pop("last_grads", None)
        gen = seeded(lambda: TalkingFaceGenerator(width=1.0), SEED).state_dict()
        frames, boxes, mels = lipsync_inputs(PAR_FRAMES, SEED + 96)
        gen_ref = inference.generate_frames(gen, frames, boxes, mels,
                                            GanConfig(serve_int8=True), PreprocessConfig(),
                                            1.0, device=device)
        np.save(os.path.join(work.name, "frames.npy"), gen_ref)
        ring_ref = {}
        q, k, v, do = _ring_inputs(device)
        for causal in (False, True):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = attention_reference(*leaves, causal=causal)
            grads = torch.autograd.grad(o, leaves, do)
            ring_ref["causal" if causal else "plain"] = [o.detach().cpu()] + [
                g.cpu() for g in grads]
            del leaves, o, grads
        del q, k, v, do
        torch.save(ring_ref, os.path.join(work.name, "ring.pt"))
        vivit = seeded(lambda: ViViT(ViViTConfig()), SEED).to(device).eval()
        torch.save(_par_serve_request(vivit, None, device).cpu(),
                   os.path.join(work.name, "serve.pt"))
        del vivit
        for k, n in _par_counts().items():
            launches[k] += n
        torch.cuda.empty_cache()

        runs = {
            "bf16": group.run(_par_diffusion_task, bf16, 2, {}, False, refs["bf16"]["file"]),
            "bf16_zero1": group.run(_par_diffusion_task, bf16, 2, {"zero1": True}, False,
                                    refs["bf16"]["file"]),
            "f32": group.run(_par_diffusion_task, f32, 1, {}, False, refs["f32"]["file"]),
            "f32_fault": group.run(_par_diffusion_task, f32, 1, {}, True,
                                   refs["f32"]["file"]),
            "generate_int8": group.run(_par_generate_task,
                                       os.path.join(work.name, "frames.npy")),
            "ring": group.run(_par_ring_task, os.path.join(work.name, "ring.pt")),
            "vivit_sp": group.run(_par_vivit_sp_task),
            "pp_micro2": group.run(_par_pp_task, 2),
            "pp_micro4": group.run(_par_pp_task, 4),
            "serve": group.run(_par_serve_task, os.path.join(work.name, "serve.pt")),
        }
        tp_runs, tp_one = _par_tp(dev, group, work.name)
        runs.update(tp_runs)
        for name, ranks in runs.items():
            backends = {r["backend"] for r in ranks}
            if backends != {"gloo"}:
                raise AssertionError(f"{name}: backends {backends}")
            per_rank = [{k: n for k, n in r["counts"].items() if n} for r in ranks]
            log("parallel", f"{name} (backend gloo, 2 ranks on cuda:0): launches a rank "
                f"{per_rank}; gloo transport a rank "
                + ", ".join(f"{r['transport_calls']} calls, {r['transport_bytes'] / 1e6:.1f} MB, "
                            f"{r['transport_s'] * 1e3:.1f} ms" for r in ranks))
            if not name.endswith("_fault"):
                for r in ranks:
                    for k, n in r["counts"].items():
                        launches[k] += n
        _par_gates(dev, runs, refs)
        _tp_gates(dev, runs, tp_one)
    finally:
        for proc in (p for k, p in launched.items() if k != "t0"):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if group is not None:
            group.close()
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        work.cleanup()
    log("parallel", f"phase took {time.perf_counter() - phase_t0:.1f} s on {dev['smi']}")
    return {"launches": launches}


def _par_gates(dev: dict, runs: dict, refs: dict) -> None:
    """Hold the two-rank results against one process's and print them."""
    lr = 1e-4   # DiffusionConfig.learning_rate
    bf = runs["bf16"]
    if bf[0]["digest"] != bf[1]["digest"]:
        raise AssertionError("bf16 data-parallel diffusion: the ranks' params differ")
    z1 = runs["bf16_zero1"]
    if {r["digest"] for r in z1} != {bf[0]["digest"]} or not z1[0]["moments_sharded"] >= 1:
        raise AssertionError("ZeRO-1: params differ from plain data parallelism's (or no "
                             "moment was sharded)")
    loss_rel = abs(bf[0]["losses"][0] - refs["bf16"]["losses"][0]) / abs(refs["bf16"]["losses"][0])
    pmax = _worst(r["param_max"] for r in bf)
    g_bf = _worst(r["grads_rel"] for r in bf)
    for r in bf + z1:
        want = {"flash_attention": 32, "flash_bwd_dkv": 32, "flash_bwd_dq": 32, "small_mha": 8}
        if any(r["counts"][k] != n for k, n in want.items()):
            raise AssertionError(f"bf16 diffusion rank launches {r['counts']}, want {want}")
    # written so that a NaN fails: every comparison with NaN is false
    if not (loss_rel <= TOL_PAR_LOSS_BF16 and g_bf <= TOL_PAR_GRAD_BF16 and pmax <= 4 * lr):
        raise AssertionError(f"bf16 data-parallel diffusion against one process: loss "
                             f"{loss_rel:.3g} (want <= {TOL_PAR_LOSS_BF16}), first gradient "
                             f"{g_bf:.3g} (want <= {TOL_PAR_GRAD_BF16}), params {pmax:.3g} "
                             f"(want <= {4 * lr})")
    one_ms = refs["bf16"]["step_ms"][-1]
    two_ms = max(r["step_ms"][-1] for r in bf)
    share = max(r["transport_s"] / (sum(r["step_ms"]) / 1e3) for r in bf)
    log("parallel", f"bf16 diffusion step at the DiffusionConfig defaults, global batch "
        f"{PAR_BATCH}: the 2 ranks' params equal bit for bit, ZeRO-1 ({z1[0]['moments_sharded']} "
        f"moment leaves sharded a rank) equal to plain data parallelism bit for bit; against one "
        f"process on the 8 rows: first loss {loss_rel:.3g} relative (want <= "
        f"{TOL_PAR_LOSS_BF16}), first reduced gradient {g_bf:.3g} relative L2 (want <= "
        f"{TOL_PAR_GRAD_BF16}), params after 2 steps at most {pmax:.3g} apart (want <= 4 lr = "
        f"{4 * lr:g}); step time: one process, batch 8: {one_ms:.1f} ms; 2 ranks sharing the card, "
        f"4 rows each: {two_ms:.1f} ms (the card is shared: no speed-up to claim); gloo "
        f"transport {share:.1%} of a rank's step time on {dev['smi']}")
    f32, fault = runs["f32"], runs["f32_fault"]
    g = _worst(r["grads_rel"] for r in f32)
    loss = abs(f32[0]["losses"][0] - refs["f32"]["losses"][0]) / abs(refs["f32"]["losses"][0])
    g_fault = _worst(r["grads_rel"] for r in fault)
    if f32[0]["digest"] != f32[1]["digest"] or not (g <= TOL_PAR_GRAD and loss <= TOL_PAR_LOSS):
        raise AssertionError(f"float32 data-parallel step: gradient {g:.3g} (want <= "
                             f"{TOL_PAR_GRAD}), loss {loss:.3g} (want <= {TOL_PAR_LOSS})")
    if not (g_fault > TOL_PAR_GRAD and g_fault > TOL_PAR_GRAD_BF16 and math.isfinite(g_fault)):
        raise AssertionError(f"the planted fault (rank 1's gradient x {PAR_FAULT}) passed a "
                             f"gradient gate: {g_fault:.3g} (gates {TOL_PAR_GRAD}, bf16 "
                             f"{TOL_PAR_GRAD_BF16})")
    for i, r in enumerate(f32 + fault):   # both ranks, clean and with the fault
        _flash_tiled("parallel", f"float32 data-parallel step, rank {i % 2}",
                     {k: {v: n for v, n in c.items() if n} for k, c in r["flash_variants"].items()})
    log("parallel", f"float32 step at 64x64 (full channel plan), global batch {PAR_BATCH}: "
        f"reduced gradient {g:.3g} relative L2 from one process's (gate {TOL_PAR_GRAD}), loss "
        f"{loss:.3g} (gate {TOL_PAR_LOSS}); planted fault, rank 1's gradient x {PAR_FAULT} "
        f"before the reduction: {g_fault:.3g}, caught by the gate")
    gen = runs["generate_int8"]
    worst = _worst(r["max_diff"] for r in gen)
    if not worst <= 1 or tuple(gen[0]["shape"]) != (PAR_FRAMES,) + LIPSYNC_HW + (3,):
        raise AssertionError(f"int8 generate_frames on 2 ranks: frames {worst} levels from one "
                             "process's")
    for r in gen:
        if r["counts"]["int8_matmul"] != 51:
            raise AssertionError(f"int8 generate_frames: K6 {r['counts']['int8_matmul']} a rank, "
                                 "want 51")
    log("parallel", f"int8 generate_frames at width 1.0, {PAR_FRAMES} frames of 360x640, "
        f"{PAR_FRAMES // 2} a "
        f"rank: frames against one process's: max {worst:g} level(s), "
        f"{min(r['equal_share'] for r in gen):.6f} of the values equal; K6 51 a rank")
    ring = runs["ring"]
    for r in ring:
        for kind in ("plain", "causal"):
            if not r[kind]["err"] <= TOL_RING:
                raise AssertionError(f"ring attention {kind}: {r[kind]['err']:.3g} of the largest "
                                     f"(want <= {TOL_RING})")
    log("parallel", f"ring_attention {RING_SHAPE} float32 over 2 ranks of the model axis, "
        "forward and backward against attention_reference: "
        + ", ".join(f"{kind} {_worst(r[kind]['err'] for r in ring):.3g} of the largest, "
                    f"{max(r[kind]['ms'] for r in ring):.1f} ms" for kind in ("plain", "causal"))
        + f" (gate {TOL_RING}) on {dev['smi']}")
    sp = runs["vivit_sp"]
    if not all(r["err"] <= TOL_LOGITS and r["finite"] for r in sp):
        raise AssertionError(f"sequence-parallel ViViT: logits {_worst(r['err'] for r in sp):.3g} "
                             f"from local (want <= {TOL_LOGITS})")
    log("parallel", f"ViViT defaults (12 layers, 80 tokens, bf16) with sequence_parallel over 2 "
        f"ranks (40 tokens each, ring attention): logits {_worst(r['err'] for r in sp):.3g} "
        f"max abs, "
        f"{_worst(r['rel'] for r in sp):.3g} relative L2 from the local forward (K2 "
        f"{sp[0]['k2_local']}x) (gate {TOL_LOGITS})")
    for name in ("pp_micro2", "pp_micro4"):
        pp = runs[name]
        le, ge = _worst(r["logit_err"] for r in pp), _worst(r["grad_rel"] for r in pp)
        if not (le <= TOL_PP and ge <= TOL_PP) or [r["stage"] for r in pp] != [[0, 6], [6, 12]]:
            raise AssertionError(f"{name}: logits {le:.3g}, gradients {ge:.3g} (want <= "
                                 f"{TOL_PP}), stages {[r['stage'] for r in pp]}")
        log("parallel", f"pipelined ViViT, 2 stages of 6 layers, n_micro {name[-1]}, float32: "
            f"logits {le:.3g} max abs from the canonical model, one train step's gradients at "
            f"most {ge:.3g} relative L2 a leaf (gate {TOL_PP}); K2 a rank "
            f"{[r['counts']['small_mha'] for r in pp]}")
    serve = runs["serve"]
    if not all(r["err"] <= TOL_LOGITS for r in serve):
        raise AssertionError(f"predict_sharded on 2 ranks: {_worst(r['err'] for r in serve):.3g}")
    for r in serve:
        if r["counts"]["clahe"] != 1 or r["counts"]["small_mha"] != 12:
            raise AssertionError(f"predict_sharded rank launches {r['counts']}, want K1 1, K2 12")
    log("parallel", f"ViViT request of {PAR_BATCH} clips, 4 a rank (ROIs by K1 on each rank's "
        f"frames, then predict_sharded): log-probs {_worst(r['err'] for r in serve):.3g} from one "
        f"process's (gate {TOL_LOGITS}), top-1 agreement {min(r['top1'] for r in serve):.4f}")


def phase_microbench() -> dict:
    """K6's own entry point: both type pairs at 4096³ beside the library;
    then ``int8_dense`` at a ViViT Dense shape, its (in, out) kernel a
    row-major B (route "packed"), against its CPU plain path."""
    from lipreading_video_generation_tpu_torch.bench import microbench_int8
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm
    from lipreading_video_generation_tpu_torch.ops import quant

    _zero_counts()
    res = microbench_int8.run(size=4096, iters=10, seed=SEED)
    want = {"k6_bf16": "sm90", "k6_int8": "packed", "k6_int8_kmajor": "sm90"}
    int8_routes = dict(mm.int8_matmul.route_counts)
    # as many products with each layout of B, one pack of B for each row-major one
    if (res["routes"] != want or mm.bf16_matmul.route_counts["packed"]
            or mm.bf16_matmul.pack_launch_count
            or int8_routes["sm90"] != int8_routes["packed"]
            or mm.int8_matmul.pack_launch_count != int8_routes["packed"]
            or mm.pack_k_major.path_counts["transpose"] != int8_routes["packed"]):
        raise AssertionError(f"microbench routes {res['routes']}, {int8_routes}, "
                             f"{mm.bf16_matmul.route_counts}, packs {mm.int8_matmul.pack_launch_count}"
                             f" {mm.pack_k_major.path_counts}; want {want}")
    log("microbench", f"4096^3: K6 bf16 {res['k6_bf16_ms']:.4f} ms (B row-major, route sm90), "
        f"torch.matmul bf16 {res['torch_matmul_bf16_ms']:.4f} ms; K6 int8, B the (N,K) weight "
        f"transposed (route sm90) {res['k6_int8_kmajor_ms']:.4f} ms, torch._int_mm on the same "
        f"{res['torch_int_mm_kmajor_ms']:.4f} ms; K6 int8, B row-major (route packed: the pack "
        f"of B, then the wgmma kernel) {res['k6_int8_ms']:.4f} ms, torch._int_mm "
        f"{res['torch_int_mm_ms']:.4f} ms; routes int8 {int8_routes} bf16 "
        f"{mm.bf16_matmul.route_counts}, packs {mm.int8_matmul.pack_launch_count} "
        f"{mm.pack_k_major.path_counts}")

    # int8_dense as JAX's int8 serving calls it for an nn.Dense: the ViViT's
    # MLP-in product, (30720, 256) x (256, 768), on the card and on the CPU
    rng = np.random.default_rng(SEED + 90)
    x = torch.from_numpy(rng.standard_normal((30720, 256)).astype(np.float32))
    kernel = torch.from_numpy((rng.standard_normal((256, 768)) / 16).astype(np.float32))
    bias = torch.from_numpy((0.02 * rng.standard_normal(768)).astype(np.float32))
    before = (mm.int8_matmul.launch_count, dict(mm.int8_matmul.route_counts),
              mm.int8_matmul.pack_launch_count)
    t0 = time.perf_counter()
    got = quant.int8_dense(x.cuda(), kernel.cuda(), bias.cuda()).cpu()
    card_s = time.perf_counter() - t0
    took = (mm.int8_matmul.launch_count - before[0],
            {r: c - before[1][r] for r, c in mm.int8_matmul.route_counts.items() if c != before[1][r]},
            mm.int8_matmul.pack_launch_count - before[2])
    want_out = quant.int8_dense(x, kernel, bias)
    err = (got - want_out).abs().max().item()
    if took != (1, {"packed": 1}, 1) or not torch.equal(got, want_out):
        raise AssertionError(f"int8_dense (30720,256)x(256,768): launches, routes, packs {took}; "
                             f"max|d| from the CPU plain path {err}")
    log("microbench", f"int8_dense (30720,256) x (256,768) float32: one pack of the (in,out) "
        f"kernel and one wgmma product (route packed), output equal to the CPU plain path's "
        f"(max|d| {err}); {card_s:.3f} s on the card with the copies")
    launches = {"int8_matmul": mm.int8_matmul.launch_count,
                "bf16_matmul": mm.bf16_matmul.launch_count,
                "matmul_pack": mm.pack_k_major.launch_count}
    log("microbench", f"launches {launches}")
    return {"launches": launches, "result": res}


def _event_ms(fn, n: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _plain_vs_kernel(plain, kernel, n: int, n_kernel: int = 0):
    """Warm up both, then time them in turns (plain, kernel, kernel, plain):
    ``n`` calls a turn, ``n_kernel`` for the kernel's where it is given."""
    plain(), kernel()
    torch.cuda.synchronize()
    nk = n_kernel or n
    p1, k1, k2, p2 = (_event_ms(plain, n), _event_ms(kernel, nk),
                      _event_ms(kernel, nk), _event_ms(plain, n))
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def _bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and the
    operations over the tensor-core peak of their type."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_OPS_S[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _attention_bound(b: int, h: int, s: int, d: int, ops_per_sd: float, n_tensors: int) -> dict:
    """bf16 attention at (b, h, s, d): ``n_tensors`` (b, h, s, d) tensors and
    the float32 lse move; ``ops_per_sd``·b·h·s²·d operations."""
    return _bound(n_tensors * b * h * s * d * 2 + b * h * s * 4, ops_per_sd * b * h * s * s * d,
                  "bf16")


def _flash_fwd_sm90_launcher(q, k, v):
    """A function that launches the tensor-core K3 on (B, H, S, D) bf16 q, k,
    v through its C entry point, into outputs allocated here, once: what
    ``ops/attention._flash_launch`` does, without its host work per call and
    without its count."""
    import ctypes

    from lipreading_video_generation_tpu_torch.ops import _build

    b, h, s_q, d = q.shape
    out = torch.empty(b, s_q, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b, h, s_q, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel("lvg_flash_fwd_sm90", [vp] * 5 + [i32] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, vp])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, s_q,
            k.shape[2], d, strides, 1.0 / math.sqrt(d), 0)

    def launch():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "flash_attention (sm90)")

    return launch


def _flash_f32_timing() -> dict:
    """The float32 CUDA-core K3 (``csrc/flash_fwd.cu``) and K4/K5
    (``csrc/flash_bwd.cu``) in both variants at the float32 U-Net's three
    attention shapes at 64x64 and its heaviest at the 128x128 defaults,
    beside SDPA float32's forward and backward (``bench/flash_fwd_timing.run``,
    ``bench/flash_bwd_timing.run``): ``fwd`` and ``bwd``."""
    from lipreading_video_generation_tpu_torch.bench import flash_bwd_timing, flash_fwd_timing

    return {"fwd": flash_fwd_timing.run(SEED + 80), "bwd": flash_bwd_timing.run(SEED + 80)}


def _flash_fwd_f32_rows(dev: dict, res: dict) -> tuple:
    """Log ``bench/flash_fwd_timing.run``'s K3 float32 readings with each
    variant's bound and share of it, hold them (both variants within
    TOL_K3_F32 of the plain version, lse within TOL_LSE, equal bits of two
    launches; the partials of a split within TOL_K3_F32 of their plain
    version and the combine kernel on them within TOL_K3_F32 of its; every
    launch through the wrapper by the variant the port picks: "tiled"), and
    return the JSON rows (shape -> readings) and the combine kernel's
    (shape -> readings, at the shapes that split)."""
    rows, combine = {}, {}
    for name, r in res.items():
        shape = tuple(r["shape"])
        bound = _bound(r["bytes"], r["ops"], "f32")
        tiled = r["tiled"]
        parts = tiled.get("partials_err", {})
        if not (r["picked"] == "tiled" and set(r["wrapper_launches"]) == {"tiled"}
                and r["wrapper_combines"] == (r["wrapper_launches"]["tiled"]
                                              if r["n_split"] > 1 else 0)
                and all(r[v]["o_err"] <= TOL_K3_F32 and r[v]["lse_err"] <= TOL_LSE
                        and r[v]["equal_bits"] for v in ("tiled", "general"))
                and all(e <= TOL_K3_F32 for e in parts.values())):
            raise AssertionError(f"K3 f32 timing {shape}: {r}")
        rows[name] = dict(shape=list(shape), variant=r["picked"], n_split=r["n_split"],
                          ms=tiled["graph_ms"], wrapper_ms=r["wrapper_ms"],
                          plain_ms=r["plain_ms"], library_ms=r["sdpa_fwd_ms"],
                          launches=r["wrapper_launches"], **bound,
                          tiled_ms_by_splits=r["tiled_splits_ms"],
                          variants={v: dict(ms=r[v]["graph_ms"], n_split=r[v]["n_split"],
                                            share=bound["bound_ms"] / r[v]["graph_ms"],
                                            o_err=r[v]["o_err"], lse_err=r[v]["lse_err"])
                                    for v in ("tiled", "general")})
        log("timing", f"K3 flash_attention {shape} f32, route cuda_core, from a CUDA graph of 20 "
            "launches of the C entry point: "
            + ", ".join(f"{v} {r[v]['graph_ms']:.4f} ms ({bound['bound_ms'] / r[v]['graph_ms']:.1%}"
                        f" of the bound; {r[v]['n_split']} key splits)" for v in ("tiled", "general"))
            + f"; tiled by key splits {r['tiled_splits_ms']}; bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']}; through flash_attention ({r['picked']}) {r['wrapper_ms']:.4f} "
            f"ms, launches counted {r['wrapper_launches']} and {r['wrapper_combines']} of the "
            f"combine kernel; plain {r['plain_ms']:.4f} ms; SDPA float32's forward from a CUDA "
            f"graph of 20 calls {r['sdpa_fwd_ms']:.4f} ms: tiled "
            f"{tiled['graph_ms'] / r['sdpa_fwd_ms']:.2f} x, general "
            f"{r['general']['graph_ms'] / r['sdpa_fwd_ms']:.2f} x; O max|d|/max(1, max|ref|) tiled "
            f"{tiled['o_err']:.3g}, general {r['general']['o_err']:.3g} on {dev['smi']}")
        if parts:
            cb = _bound(tiled["combine_work"]["bytes"], tiled["combine_work"]["ops"], "f32")
            combine[name] = dict(shape=list(shape), n_split=r["n_split"], ms=tiled["combine_ms"],
                                 plain_ms=tiled["combine_plain_ms"], **cb,
                                 max_abs_err=max(parts["combine_o"], parts["combine_lse"]))
            log("timing", f"K3's combine kernel {shape} f32, {r['n_split']} key splits, from a CUDA "
                f"graph of 20 launches: {tiled['combine_ms']:.4f} ms ({cb['bound_ms'] / tiled['combine_ms']:.1%} "
                f"of the bound {cb['bound_ms']:.5f} ms by {cb['bound_by']}), plain "
                f"{tiled['combine_plain_ms']:.4f} ms; the tiled kernel's partials against "
                f"flash_partials_reference and the combine against flash_combine_reference: "
                f"{parts} on {dev['smi']}")
        if "sdpa_fwd_kernels" in r:
            log("timing", f"SDPA float32 forward {shape} runs (torch.profiler, device ms, "
                f"launches): {r['sdpa_fwd_kernels']}")
    return rows, combine


def _flash_bwd_f32_rows(dev: dict, res: dict) -> dict:
    """Log ``bench/flash_bwd_timing.run``'s K4/K5 float32 readings with each
    kernel's bound and share of it, hold them (every variant within
    TOL_BWD_F32 of the plain version with equal bits of two launches, every
    launch through the wrappers by the variant the port picks: "tiled"), and
    return the JSON rows: kernel -> shape -> readings."""
    rows = {"dkv": {}, "dq": {}}
    for name, r in res.items():
        shape = tuple(r["shape"])
        for kern in ("dkv", "dq"):
            kr = r[kern]
            bound = _bound(kr["bytes"], kr["ops"], "f32")
            if not (kr["picked"] == "tiled" and set(kr["wrapper_launches"]) == {"tiled"}
                    and all(kr[v]["max_rel_err"] <= TOL_BWD_F32 and kr[v]["equal_bits"]
                            for v in ("tiled", "general"))):
                raise AssertionError(f"K4/K5 f32 timing {shape} {kern}: {kr}")
            row = dict(shape=list(shape), variant=kr["picked"], ms=kr["tiled"]["graph_ms"],
                       wrapper_ms=kr["wrapper_ms"], plain_ms=kr["plain_ms"],
                       library_ms=r["sdpa_bwd_ms"], library_timed=r["sdpa_timed"],
                       launches=kr["wrapper_launches"], **bound,
                       variants={v: dict(ms=kr[v]["graph_ms"],
                                         share=bound["bound_ms"] / kr[v]["graph_ms"],
                                         max_rel_err=kr[v]["max_rel_err"])
                                 for v in ("tiled", "general")})
            rows[kern][name] = row
            log("timing", f"{'K4 flash_bwd_dkv' if kern == 'dkv' else 'K5 flash_bwd_dq'} "
                f"{shape} f32, route cuda_core, from a CUDA graph of 20 launches of the C entry "
                "point: "
                + ", ".join(f"{v} {kr[v]['graph_ms']:.4f} ms ({bound['bound_ms'] / kr[v]['graph_ms']:.1%}"
                            f" of the bound)" for v in ("tiled", "general"))
                + f"; bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}; through the "
                f"wrapper ({kr['picked']}) {kr['wrapper_ms']:.4f} ms, launches counted "
                f"{kr['wrapper_launches']}; plain {kr['plain_ms']:.4f} ms; max|d|/max|ref| tiled "
                f"{kr['tiled']['max_rel_err']:.3g}, general {kr['general']['max_rel_err']:.3g} "
                f"on {dev['smi']}")
        both = {v: r["dkv"][v]["graph_ms"] + r["dq"][v]["graph_ms"] for v in ("tiled", "general")}
        log("timing", f"K4 + K5 {shape} f32: tiled {both['tiled']:.4f} ms, general "
            f"{both['general']:.4f} ms, against SDPA float32's backward (dQ, dK, dV in one call, "
            f"timed from {r['sdpa_timed']}) {r['sdpa_bwd_ms']:.4f} ms: tiled "
            f"{both['tiled'] / r['sdpa_bwd_ms']:.2f} x on {dev['smi']}")
        if "sdpa_bwd_kernels" in r:
            log("timing", f"SDPA float32 backward {shape} runs (torch.profiler, device ms, "
                f"launches): {r['sdpa_bwd_kernels']}")
    return rows


def _small_mha_launcher(q, k, v, num_heads: int):
    """The same for the tensor-core K2 on (B, S, E) bf16 q, k, v: what
    ``ops/attention._small_mha_launch`` does, without its host work per call
    and without its count (the CUDA-core K2's is
    ``bench/small_mha_timing.c_entry_launcher``)."""
    import ctypes

    from lipreading_video_generation_tpu_torch.ops import _build

    b, s, e = q.shape
    d = e // num_heads
    out = torch.empty(b, s, e, dtype=q.dtype, device=q.device)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _build.kernel("lvg_small_mha_sm90", [vp] * 4 + [i32] + [i64] * 6 + [i32] * 3
                       + [ctypes.c_float, i32, vp])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), v.stride(0), v.stride(1), s, num_heads, d,
            1.0 / math.sqrt(d), 0)

    def launch():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "small_mha (sm90)")

    launch.out = out   # the kernel writes it: it lives as long as the launcher
    return launch


def _clahe_launcher(x, clip_limit: float = 0.2, grid=(8, 8), nbins: int = 256):
    """The same for K1's packed route on (N, H, W) float32 images: what
    ``ops/clahe_cuda.clahe_cuda`` launches, without its host work per call
    and without its count."""
    from lipreading_video_generation_tpu_torch.ops import _build
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl

    n, h, w = x.shape
    lay = cl.clahe_packed_layout(h, w, grid, nbins, clip_limit)
    out = torch.empty_like(x)
    fn = _build.kernel("lvg_clahe_packed_f32", cl._PACKED_ARGTYPES)
    args = (x.data_ptr(), out.data_ptr(), None, n, h, w, grid[0], grid[1], nbins, 1.0,
            lay["group"], lay["lane_words"], lay["tile_words"], lay["smem"])

    def launch():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "clahe_cuda (packed)")

    launch.out = out   # the kernel writes it: it lives as long as the launcher
    return launch


def _mm_sm90_launcher(a, b):
    """The same for the tensor-core K6 on (M, K) and (K, N) int8 or bf16
    operands that ``matmul_route`` sends to it."""
    import ctypes

    from lipreading_video_generation_tpu_torch.ops import _build

    int8 = a.dtype == torch.int8
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32 if int8 else torch.float32,
                      device=a.device)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = _build.kernel("lvg_mm_sm90_int8" if int8 else "lvg_mm_sm90_bf16",
                       [vp] * 3 + [i32] * 3 + [i64] * 3 + [vp])
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[1], a.shape[1],
            a.stride(0), b.stride(0), b.stride(1))

    def launch():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream), "matmul (sm90)")

    launch.out = out
    return launch


def phase_timing(dev: dict, microbench: dict) -> dict:
    import torch.nn.functional as F

    from lipreading_video_generation_tpu_torch.bench import small_mha_timing
    from lipreading_video_generation_tpu_torch.bench.microbench_int8 import make_operands
    from lipreading_video_generation_tpu_torch.bench.timing import graph_ms
    from lipreading_video_generation_tpu_torch.ops import attention as att
    from lipreading_video_generation_tpu_torch.ops import clahe_cuda as cl
    from lipreading_video_generation_tpu_torch.ops import matmul_cuda as mm

    x = _uniform((384 * CLIP_FRAMES, 48, 48), 0, 255, SEED)
    _zero_counts()
    with torch.inference_mode():
        k1_ms, k1_plain, raw1 = _plain_vs_kernel(
            lambda: cl.clahe_reference(x, 0.2, (8, 8)),
            lambda: cl.clahe_cuda(x, 0.2, (8, 8)), 20)
        # the kernel alone: the C entry point in a loop, output allocated once,
        # and the same calls replayed from a CUDA graph (device time only)
        k1_alone = _event_ms(_clahe_launcher(x), 200)
        k1_graph = graph_ms(_clahe_launcher(x), 50)
        # whole frames, as contrast_boost will give them: the tiled route
        frames = _uniform((64, 360, 640), 0, 255, SEED)
        k1f_ms, k1f_plain, raw1f = _plain_vs_kernel(
            lambda: cl.clahe_reference(frames, 0.2, (8, 8)),
            lambda: cl.clahe_cuda(frames, 0.2, (8, 8)), 3, 20)
        if cl.clahe_cuda.route_counts != {"packed": 41, "tiled": 41}:
            raise AssertionError(f"the timed K1 launches took the routes {cl.clahe_cuda.route_counts}")
        del frames
        # K2 as the main path calls it: q/k/v column slices of one qkv tensor
        q, k, v = _uniform((384, 80, 768), -2, 2, SEED, torch.bfloat16).chunk(3, dim=-1)
        k2_ms, k2_plain, raw2 = _plain_vs_kernel(
            lambda: att._mha_einsum(q, k, v, 8, False),
            lambda: att.small_mha(q, k, v, 8), 20)
        if att.small_mha.route_counts["cuda_core"]:
            raise AssertionError("the timed K2 launches did not all take the tensor-core kernel")
        q4, k4, v4 = (t.reshape(384, 80, 8, 32).transpose(1, 2) for t in (q, k, v))
        F.scaled_dot_product_attention(q4, k4, v4)
        k2_lib = _event_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
        # the kernel alone, as for K3 below: the C entry point in a loop
        k2_alone = _event_ms(_small_mha_launcher(q, k, v, 8), 100)
        # K2's CUDA-core route at the five float32 shapes of the main paths:
        # through small_mha, its C entry point in a loop and from a CUDA graph,
        # SDPA float32 from a CUDA graph (bench/small_mha_timing.py)
        before = att.small_mha.route_counts["cuda_core"]
        k2c = small_mha_timing.run(SEED)
        n_k2c = att.small_mha.route_counts["cuda_core"] - before
        # K3 at the U-Net's three shapes, batch DIFF_FRAMES, as the U-Net
        # calls it: (B, 1, S, D) views of column slices of one qkv tensor
        k3, k3_lib, k3_alone = {}, {}, {}
        for s, d in ((16384, 64), (4096, 128), (1024, 256)):
            qkv = _uniform((DIFF_FRAMES, s, 3 * d), -2, 2, SEED, torch.bfloat16)
            q, k, v = (t.reshape(DIFF_FRAMES, s, 1, d).transpose(1, 2)
                       for t in qkv.chunk(3, dim=-1))
            before = att.flash_attention.route_counts["sm90"]
            k3[(s, d)] = _plain_vs_kernel(lambda: att.flash_reference(q, k, v),
                                          lambda: att.flash_attention(q, k, v), 3, 20)
            if att.flash_attention.route_counts["sm90"] != before + 41:
                raise AssertionError("the timed K3 launches did not take the tensor-core kernel")
            F.scaled_dot_product_attention(q, k, v)
            k3_lib[(s, d)] = _event_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
            # the kernel alone: at the small shapes a call's host time (two
            # allocations, the route, ctypes), not its kernel, is what the
            # events above see, so the C entry point is also called in a loop
            # on outputs allocated once
            k3_alone[(s, d)] = _event_ms(_flash_fwd_sm90_launcher(q, k, v), 50)
            del qkv, q, k, v
    for (s, d), (ms, plain, raw) in k3.items():
        flops = 4.0 * DIFF_FRAMES * s * s * d
        bound = _attention_bound(DIFF_FRAMES, 1, s, d, 4, 4)["bound_ms"]
        log("timing", f"K3 flash_attention ({DIFF_FRAMES},1,{s},{d}) bf16, route sm90: kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s; bound {bound:.4f} ms, {bound / ms:.1%} "
            f"of it), plain {plain:.4f} ms (plain,kernel,kernel,plain = "
            f"{[round(t, 4) for t in raw]}), the library's forward (SDPA) {k3_lib[(s, d)]:.4f} ms: "
            f"{ms / k3_lib[(s, d)]:.2f} x; the C entry point in a loop, outputs allocated once: "
            f"{k3_alone[(s, d)]:.4f} ms ({flops / k3_alone[(s, d)] / 1e9:.2f} TFLOP/s) on "
            f"{dev['smi']}")
    n_img = 384 * CLIP_FRAMES * 48 * 48
    k1_bound = _bound(2 * n_img * 4, 0, "bf16")["bound_ms"]
    k1f_bound = _bound(2 * 64 * 360 * 640 * 4, 0, "bf16")["bound_ms"]
    log("timing", f"K1 clahe (1920,48,48) f32 grid (8,8) clip 0.2, route packed: through clahe_cuda "
        f"{k1_ms:.4f} ms ({k1_bound / k1_ms:.1%} of the bound {k1_bound:.4f} ms by bytes), the C "
        f"entry point in a loop, output allocated once {k1_alone:.4f} ms "
        f"({k1_bound / k1_alone:.1%} of the bound), the same calls from a CUDA graph "
        f"{k1_graph:.4f} ms ({k1_bound / k1_graph:.1%} of the bound; the one-block-an-image "
        "kernel it replaced: 0.0985 ms through its wrapper), "
        f"plain {k1_plain:.4f} ms (plain,kernel,kernel,plain = {[round(t, 4) for t in raw1]}); "
        f"(64,360,640) grid (8,8), route tiled: {k1f_ms:.4f} ms ({k1f_bound / k1f_ms:.1%} of the "
        f"bound {k1f_bound:.4f} ms), plain {k1f_plain:.4f} ms (plain,kernel,kernel,plain = "
        f"{[round(t, 4) for t in raw1f]}) on {dev['smi']}")
    # the float32 CUDA-core K3 and K4/K5 at the float32 U-Net's shapes, as a
    # float32 step at batch 2 calls them, against SDPA float32's forward and
    # backward (outside inference mode: the library's backward needs its graph)
    fl = _flash_f32_timing()
    k2c_rows = {}
    for name, r in k2c.items():
        bound = _bound(r["bytes"], r["ops"], "f32")
        k2c_rows[name] = dict(variant=r["variant"], ms=r["graph_ms"], c_entry_ms=r["c_entry_ms"],
                              wrapper_ms=r["wrapper_ms"], plain_ms=r["plain_ms"],
                              library_ms=r["sdpa_graph_ms"], max_abs_err=r["max_abs_err"],
                              **bound)
        log("timing", f"K2 small_mha {tuple(r['shape'])} H={r['heads']} causal={r['causal']} f32"
            f"{' on qkv slices' if r['layout'] == 'qkv' else ''} ({name}), route cuda_core, "
            f"variant {r['variant']}: from a CUDA graph of {small_mha_timing.GRAPH_LAUNCHES} "
            f"launches {r['graph_ms']:.4f} ms ({bound['bound_ms'] / r['graph_ms']:.1%} of the "
            f"bound {bound['bound_ms']:.5f} ms by {bound['bound_by']}); the C entry point in a "
            f"loop, output allocated once {r['c_entry_ms']:.4f} ms; through small_mha "
            f"{r['wrapper_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; SDPA float32 from a CUDA "
            f"graph of {small_mha_timing.GRAPH_LAUNCHES} calls {r['sdpa_graph_ms']:.4f} ms "
            f"(kernel/SDPA {r['graph_ms'] / r['sdpa_graph_ms']:.2f} x); max|d| "
            f"{r['max_abs_err']:.3g} from _mha_einsum on {dev['smi']}")
    log("timing", f"K2 cuda_core launches counted while timed through small_mha: {n_k2c}")
    fwd_rows, combine_rows = _flash_fwd_f32_rows(dev, fl["fwd"])
    bwd_rows = _flash_bwd_f32_rows(dev, fl["bwd"])
    k2_bound = _attention_bound(384, 8, 80, 32, 4, 4)["bound_ms"]
    log("timing", f"K2 small_mha (384,80,256) H=8 bf16, route sm90: kernel {k2_ms:.4f} ms (bound "
        f"{k2_bound:.4f} ms by bytes, {k2_bound / k2_ms:.1%} of it), plain "
        f"{k2_plain:.4f} ms (plain,kernel,kernel,plain = {[round(t, 4) for t in raw2]}), the "
        f"library's forward (SDPA) {k2_lib:.4f} ms: {k2_ms / k2_lib:.2f} x; the C entry point in a "
        f"loop, output allocated once: {k2_alone:.4f} ms ({k2_bound / k2_alone:.1%} of the bound) "
        f"on {dev['smi']}")
    # K4 and K5 at the same shapes, each against the part of the plain
    # backward that gives its outputs
    bwd, bwd_lib = {}, {}
    for s, d in ((16384, 64), (4096, 128), (1024, 256)):
        qkv = _uniform((DIFF_FRAMES, s, 3 * d), -2, 2, SEED, torch.bfloat16)
        q, k, v = (t.reshape(DIFF_FRAMES, s, 1, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        do = _uniform((DIFF_FRAMES, s, d), -1, 1, SEED + 1, torch.bfloat16).reshape(
            DIFF_FRAMES, s, 1, d).transpose(1, 2)
        with torch.no_grad():
            o, lse = att.flash_attention(q, k, v, return_lse=True)
            delta = (do.float() * o.float()).sum(-1)
            bwd[("dkv", s, d)] = _plain_vs_kernel(
                lambda: att.flash_backward_reference(q, k, v, do, lse, delta, dq=False),
                lambda: att.flash_bwd_dkv(q, k, v, do, lse, delta), 3, 20)
            bwd[("dq", s, d)] = _plain_vs_kernel(
                lambda: att.flash_backward_reference(q, k, v, do, lse, delta, dkv=False),
                lambda: att.flash_bwd_dq(q, k, v, do, lse, delta), 3, 20)
        # the library's whole backward (dQ, dK and dV in one call)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves)
        torch.autograd.grad(out, leaves, do, retain_graph=True)
        bwd_lib[(s, d)] = _event_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 20)
        del leaves, out
        del qkv, q, k, v, do, o, lse, delta
    for (kern, s, d), (ms, plain, raw) in bwd.items():
        ops_per_sd, n_tensors = (8, 6) if kern == "dkv" else (6, 5)
        flops = float(ops_per_sd) * DIFF_FRAMES * s * s * d
        bound = _attention_bound(DIFF_FRAMES, 1, s, d, ops_per_sd, n_tensors)["bound_ms"]
        name = "K4 flash_bwd_dkv" if kern == "dkv" else "K5 flash_bwd_dq"
        log("timing", f"{name} ({DIFF_FRAMES},1,{s},{d}) bf16, route sm90: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s; bound {bound:.4f} ms, {bound / ms:.1%} of it), "
            f"plain {plain:.4f} ms (plain,kernel,kernel,plain = {[round(t, 4) for t in raw]}) "
            f"on {dev['smi']}")
    for (s, d), lib in bwd_lib.items():
        both = bwd[("dkv", s, d)][0] + bwd[("dq", s, d)][0]
        log("timing", f"K4 + K5 ({DIFF_FRAMES},1,{s},{d}) bf16: {both:.4f} ms against the "
            f"library's backward (SDPA, dQ, dK, dV in one call) {lib:.4f} ms: {both / lib:.2f} x "
            f"on {dev['smi']}")
    log("timing", f"library calls at the same shapes ({dev['smi']}): "
        f"F.scaled_dot_product_attention (384,8,80,32) {k2_lib:.4f} ms, "
        + ", ".join(f"({DIFF_FRAMES},1,{s},{d}) {ms:.4f} ms" for (s, d), ms in k3_lib.items()))
    bwd_lib = bwd_lib[(16384, 64)]

    # K6 int8 as int8 serving calls it (B the (N, K) weight transposed), at the
    # generator's largest product, the ViViT's qkv product, the generator's
    # mel stem and its 1x1 bottleneck (8 tiles for all SMs and a long K), each
    # beside torch._int_mm and through the C entry point alone; bf16 and int8 at the microbench's 4096^3 (kernel and
    # library times from its run)
    k6 = {}
    for m, kk, n in ((128 * 96 * 96, 1440, 64), (30720, 256, 768), (65536, 16, 32),
                     (128, 4608, 512)):
        a8, w8 = _int8((m, kk), SEED + 70), _int8((n, kk), SEED + 71)
        before = mm.int8_matmul.route_counts["sm90"]
        ms, plain, raw = _plain_vs_kernel(lambda: mm.matmul_reference(a8, w8.t()),
                                          lambda: mm.int8_matmul(a8, w8.t()), 3, 20)
        if mm.int8_matmul.route_counts["sm90"] != before + 41:
            raise AssertionError("the timed K6 launches did not take the tensor-core kernel")
        w8_rows = w8.t().contiguous()
        torch._int_mm(a8, w8_rows)
        lib = _event_ms(lambda: torch._int_mm(a8, w8_rows), 20)
        alone = _event_ms(_mm_sm90_launcher(a8, w8.t()), 50)
        bound = _bound(m * kk + kk * n + m * n * 4, 2.0 * m * kk * n, "int8")
        k6[(m, kk, n)] = dict(ms=ms, plain_ms=plain, library_ms=lib, **bound)
        log("timing", f"K6 int8_matmul ({m} x {kk} x {n}), B the (N,K) weight transposed, route "
            f"sm90: kernel {ms:.4f} ms ({2.0 * m * kk * n / ms / 1e9:.2f} TOP/s, "
            f"{(m * kk + m * n * 4) / ms / 1e6:.1f} GB/s of A and C; bound {bound['bound_ms']:.4f} "
            f"ms by {bound['bound_by']}, {bound['bound_ms'] / ms:.1%} of it), plain (float64 "
            f"matmul) {plain:.4f} ms (plain,kernel,kernel,plain = {[round(t, 4) for t in raw]}), "
            f"torch._int_mm {lib:.4f} ms: {ms / lib:.2f} x; the C entry point in a loop, output "
            f"allocated once: {alone:.4f} ms ({bound['bound_ms'] / alone:.1%} of the bound) on "
            f"{dev['smi']}")
        del a8, w8, w8_rows
    mb = microbench["result"]
    ops = make_operands(4096, SEED, "cuda")
    mm.matmul_reference(ops["a16"], ops["b16"])
    bf16_plain = _event_ms(lambda: mm.matmul_reference(ops["a16"], ops["b16"]), 5)
    alone16 = _event_ms(_mm_sm90_launcher(ops["a16"], ops["b16"]), 20)
    alone8 = _event_ms(_mm_sm90_launcher(ops["a8"], ops["b8_kmajor"]), 20)
    # K6's pack at the microbench's row-major int8 B read as (N, K), the
    # 4096^2 transposition of its "packed" route: through pack_k_major beside
    # pack_reference, and the kernel and one library call that makes the same
    # copy (.contiguous() of the transposed view; timed only) from CUDA graphs
    bt = ops["b8"].t()
    before = mm.pack_k_major.path_counts["transpose"]
    pack_ms, pack_plain, raw_p = _plain_vs_kernel(lambda: mm.pack_reference(bt),
                                                  lambda: mm.pack_k_major(bt), 5, 20)
    if mm.pack_k_major.path_counts["transpose"] != before + 41:
        raise AssertionError("the timed K6 packs did not take the transposing path")
    pack_graph = graph_ms(lambda: mm.pack_k_major(bt), 20)
    pack_lib = graph_ms(lambda: bt.contiguous(), 20)
    pack_bound = _bound(2 * 4096 * 4096, 0, "int8")
    log("timing", f"K6 pack 4096^2 int8, B row-major read as (N,K) (path transpose): "
        f"{pack_graph:.4f} ms from a CUDA graph of 20 (bound {pack_bound['bound_ms']:.4f} ms by "
        f"bytes, {pack_bound['bound_ms'] / pack_graph:.1%} of it; the source is the same 16 MB "
        f"each launch, so it reads from a warm L2), {pack_ms:.4f} ms through pack_k_major, "
        f"plain (pack_reference) {pack_plain:.4f} ms (plain,kernel,kernel,plain = "
        f"{[round(t, 4) for t in raw_p]}), .contiguous() from a graph {pack_lib:.4f} ms "
        f"({pack_graph / pack_lib:.2f} x) on {dev['smi']}")
    del ops, bt
    bound16 = _bound(2 * 4096 * 4096 * 2 + 4096 * 4096 * 4, 2.0 * 4096 ** 3, "bf16")
    bound8 = _bound(2 * 4096 * 4096 + 4096 * 4096 * 4, 2.0 * 4096 ** 3, "int8")
    log("timing", f"K6 at 4096^3 (routes {mb['routes']}): bf16, B row-major: kernel "
        f"{mb['k6_bf16_ms']:.4f} ms (bound {bound16['bound_ms']:.4f} ms by operations, "
        f"{bound16['bound_ms'] / mb['k6_bf16_ms']:.1%} of it; C entry point alone {alone16:.4f} "
        f"ms), plain (float32 matmul of the upcast operands, tf32 off) {bf16_plain:.4f} ms, "
        f"torch.matmul bf16 {mb['torch_matmul_bf16_ms']:.4f} ms: "
        f"{mb['k6_bf16_ms'] / mb['torch_matmul_bf16_ms']:.2f} x; int8, B the (N,K) weight "
        f"transposed: kernel {mb['k6_int8_kmajor_ms']:.4f} ms (bound {bound8['bound_ms']:.4f} ms "
        f"by operations, {bound8['bound_ms'] / mb['k6_int8_kmajor_ms']:.1%} of it; C entry point "
        f"alone {alone8:.4f} ms), torch._int_mm {mb['torch_int_mm_kmajor_ms']:.4f} ms; int8, B "
        f"row-major (route packed: pack, then the wgmma kernel): {mb['k6_int8_ms']:.4f} ms "
        f"({bound8['bound_ms'] / mb['k6_int8_ms']:.1%} of the bound), torch._int_mm "
        f"{mb['torch_int_mm_ms']:.4f} ms: {mb['k6_int8_ms'] / mb['torch_int_mm_ms']:.2f} x on "
        f"{dev['smi']}")
    m, kk, n = 128 * 96 * 96, 1440, 64

    # the JSON line carries K3, K4 and K5 at the U-Net's FLOP-heaviest shape
    return {
        "clahe": dict(ms=k1_ms, plain_ms=k1_plain, library_ms=None, c_entry_ms=k1_alone,
                      c_entry_graph_ms=k1_graph,
                      profiled_ms_in_request=K1_PROFILED_MS[-1],
                      frames_64x360x640=dict(route="tiled", ms=k1f_ms, plain_ms=k1f_plain,
                                             bound_ms=k1f_bound),
                      **_bound(2 * n_img * 4, 0, "bf16")),
        # cuda_core: a main path's shape each, timed from a CUDA graph (ms) and
        # three more ways, SDPA float32 from a CUDA graph as library_ms
        "small_mha": dict(ms=k2_ms, plain_ms=k2_plain, library_ms=k2_lib, cuda_core=k2c_rows,
                          **_attention_bound(384, 8, 80, 32, 4, 4)),
        # cuda_core_f32: the float32 CUDA-core kernel at four shapes, by variant
        # (ms from a CUDA graph of 20 launches), library_ms SDPA float32's forward
        "flash_attention": dict(ms=k3[(16384, 64)][0], plain_ms=k3[(16384, 64)][1],
                                library_ms=k3_lib[(16384, 64)], cuda_core_f32=fwd_rows,
                                **_attention_bound(DIFF_FRAMES, 1, 16384, 64, 4, 4)),
        # K3's combine kernel at the float32 U-Net's shapes that split the key
        # axis (no one PyTorch call computes it); the first of them on top
        "flash_fwd_combine": dict(**{k_: v_ for k_, v_ in next(iter(combine_rows.values())).items()
                                     if k_ not in ("max_abs_err",)},
                                  library_ms=None, by_shape=combine_rows) if combine_rows else None,
        # K4 reads q, k, v, dO and writes dK, dV; K5 reads the four and writes
        # dQ; both read lse and delta. The library call covers both kernels.
        # cuda_core_f32: the float32 CUDA-core kernels at four shapes, by
        # variant (ms from a CUDA graph of 20 launches), library_ms SDPA
        # float32's whole backward
        "flash_bwd_dkv": dict(ms=bwd[("dkv", 16384, 64)][0], plain_ms=bwd[("dkv", 16384, 64)][1],
                              library_ms=bwd_lib, library_covers="flash_bwd_dkv+flash_bwd_dq",
                              cuda_core_f32=bwd_rows["dkv"],
                              **_attention_bound(DIFF_FRAMES, 1, 16384, 64, 8, 6)),
        "flash_bwd_dq": dict(ms=bwd[("dq", 16384, 64)][0], plain_ms=bwd[("dq", 16384, 64)][1],
                             library_ms=bwd_lib, library_covers="flash_bwd_dkv+flash_bwd_dq",
                             cuda_core_f32=bwd_rows["dq"],
                             **_attention_bound(DIFF_FRAMES, 1, 16384, 64, 6, 5)),
        "int8_matmul": k6[(m, kk, n)],
        "bf16_matmul": dict(ms=mb["k6_bf16_ms"], plain_ms=bf16_plain,
                            library_ms=mb["torch_matmul_bf16_ms"], **bound16),
        # ms from a CUDA graph (device time), wrapper_ms through pack_k_major,
        # library_ms .contiguous() of the transposed view from a graph
        "matmul_pack": dict(ms=pack_graph, wrapper_ms=pack_ms, plain_ms=pack_plain,
                            library_ms=pack_lib, **pack_bound),
    }



def main() -> None:
    t0 = time.perf_counter()
    dev = phase_device()
    phase_build()
    errs = phase_kernels()
    served = phase_serve(dev)
    vivit_trained = phase_vivit_train(dev)["launches"]
    lipread = _k2_rows_phase("lipread-e2e", lambda: phase_lipread_e2e(dev))["launches"]
    diffused = phase_diffuse(dev)
    trained = phase_train(dev)["launches"]
    superres = phase_superres(dev)["launches"]
    guided = phase_guidance(dev)["launches"]
    fed = phase_data(dev)["launches"]
    lipsync = phase_lipsync(dev)
    phase_flops(dev)
    gan = phase_gan(dev)
    pretrained = _k2_rows_phase("pretrained", lambda: phase_pretrained(dev))["launches"]
    features = _k2_rows_phase("features", lambda: phase_features(dev))["launches"]
    parallel = phase_parallel(dev)["launches"]
    microbench = phase_microbench()
    paths = (vivit_trained, diffused, trained, superres, guided, fed, pretrained, features)
    launches = {"clahe": (served["clahe"] + lipread["clahe"] + gan["clahe"] + features["clahe"]
                          + parallel["clahe"]),
                "small_mha": (served["small_mha"] + lipread["small_mha"]
                              + sum(p["small_mha"] for p in paths) + parallel["small_mha"]),
                "int8_matmul": (served["int8_matmul"] + lipsync["launches"] + gan["int8_matmul"]
                                + microbench["launches"]["int8_matmul"]
                                + parallel["int8_matmul"]),
                "bf16_matmul": microbench["launches"]["bf16_matmul"],
                "matmul_pack": microbench["launches"]["matmul_pack"]}
    for name in ("flash_attention", "flash_bwd_dkv", "flash_bwd_dq"):
        launches[name] = sum(p.get(name, 0) for p in paths) + parallel[name]
    # the combine kernel's main path: the float32 diffusion steps of [train],
    # [pretrained] and [parallel] (tallied by _flash_tiled)
    launches["flash_fwd_combine"] = TILED_COMBINES["flash_fwd_combine"]
    times = phase_timing(dev, microbench)
    pkg = "lipreading_video_generation_tpu_torch"
    jax_pkg = "lipreading_video_generation_tpu"
    sources = {  # name: (CUDA source, the TPU kernel it replaces)
        "clahe": ("clahe_packed.cu", f"{jax_pkg}/ops/clahe_pallas.py:102"),
        "small_mha": ("small_mha_sm90.cu", f"{jax_pkg}/ops/attention.py:570"),
        "flash_attention": ("flash_fwd_sm90.cu", f"{jax_pkg}/ops/attention.py:66"),
        # the last kv step of _flash_kernel (its _finish), where the key axis is split
        "flash_fwd_combine": ("flash_fwd.cu", f"{jax_pkg}/ops/attention.py:112"),
        "flash_bwd_dkv": ("flash_bwd_sm90.cu", f"{jax_pkg}/ops/attention.py:216"),
        "flash_bwd_dq": ("flash_bwd_sm90.cu", f"{jax_pkg}/ops/attention.py:272"),
        "int8_matmul": ("int8_mm_sm90.cu", "scripts/microbench_int8_pallas.py:44"),
        "bf16_matmul": ("int8_mm_sm90.cu", "scripts/microbench_int8_pallas.py:44"),
        # the first half of K6's "packed" route: the TPU kernel's row-major B
        "matmul_pack": ("int8_mm.cu", "scripts/microbench_int8_pallas.py:44"),
    }
    kernels = []
    if times["flash_fwd_combine"] is None:      # no float32 shape splits the key axis
        del sources["flash_fwd_combine"]
    for name, (source, replaces) in sources.items():
        kern = {"name": name, "route": "cuda", "source": f"{pkg}/csrc/{source}",
                "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
                **times[name]}
        if name == "flash_attention":
            kern["also_replaces"] = "scripts/profile_flash_dpad.py:37"
            kern["route_detail"] = (
                "sm90: wgmma on bf16 tiles, cp.async rings (aligned bf16 inputs up to head dim "
                "256; timed here and on the sampling and training paths, and wav2vec2's 12 "
                "layers on a 10.24 s wave, T' = 511); cuda_core: "
                f"{pkg}/csrc/flash_fwd.cu in two variants picked by "
                "ops/attention.flash_fwd_variant: tiled (float32 with 16-byte rows up to head dim "
                "256: 128-thread blocks of 32 query rows, two an SM, K and V by cp.async in two "
                "stages, the key axis split where the row blocks do not fill the card, "
                "flash_fwd_combine joining the splits; every float32 diffusion step, timed here "
                "under cuda_core_f32) and general (unaligned inputs, bf16 views, head dims above "
                "256 in slices of 256 columns)")
        if name == "flash_fwd_combine":
            kern["route_detail"] = (
                "the tiled K3's splits of the key axis, (m, l, unnormalised O) each, joined in "
                "split order into O and lse: a thread a float4 of O; launched once a split K3 "
                "launch on the float32 diffusion steps, timed here alone at the float32 U-Net's "
                "shapes that split (by_shape)")
        if name.startswith("flash_bwd"):
            kern["route_detail"] = (
                "sm90: wgmma on bf16 tiles, cp.async ring (aligned bf16 inputs up to head dim "
                f"256; timed here and on the training path); cuda_core: {pkg}/csrc/flash_bwd.cu "
                "in two variants picked by ops/attention.flash_bwd_variant: tiled (float32 with "
                "16-byte rows up to head dim 256: 128-thread blocks, two an SM, the streamed "
                "tiles by cp.async in two stages; every float32 diffusion training step, timed "
                "here under cuda_core_f32) and general (unaligned inputs, bf16 views, head dims "
                "above 256 in slices of 256 columns)")
        if name == "clahe":
            kern["route_detail"] = (
                "packed: one block an image, 8-bit counters packed in shared memory, an integer "
                "LUT scan written over them (L = 1, nbins a power of two up to 256, tiles of at "
                "most 255 pixels: the main path's (1920,48,48), timed here and on the ViViT "
                "serving path; once a clip of the lipreading chain); tiled: "
                f"{pkg}/csrc/clahe.cu (a block a tile writes its LUT to a device workspace, a "
                "block a row blends; any other shape, e.g. frames of 360x640: once a frame "
                "batch of ops/image.contrast_boost)")
        if name == "small_mha":
            kern["route_detail"] = (
                "sm90: mma.sync on bf16 tiles, double-buffered cp.async (aligned bf16 inputs, up "
                "to 128 tokens, head dim up to 128; timed here and on the ViViT serving and "
                f"training, lipreading-chain, sampling and diffusion training paths, and wav2vec2's "
                f"12 layers when it conditions the diffusion); cuda_core: "
                f"{pkg}/csrc/small_mha.cu (float32, longer sequences, unaligned inputs), in "
                "four variants picked by ops/attention.small_mha_variant: rows_vec4 (S <= 64, "
                "float32, 16-byte copies: a block's K and V staged in shared memory by "
                "cp.async, a group of lanes a query row over d, a key tile's dot products "
                "reduce-scattered over the group, softmax and P in registers; the lipreading "
                "chain's causal word LM, "
                "the GAN's frozen lip experts: AV-HuBERT's 12 layers on the generated and the "
                "real window, the seq2seq expert's encoder and causal decoder; the "
                "FeatureTransformer's 2 layers at head dim 512; each timed here under "
                "cuda_core), rows (the same, an element a load: unaligned, d not a multiple "
                "of 4, bf16), general_vec4 and general (S past 64 or d past the rows "
                "kernel's: a block a head, K and V staged in shared memory)")
        if name.endswith("_matmul"):
            kern["route_detail"] = (
                "sm90: wgmma on swizzled tiles, a TMA ring kept full by a producer warpgroup, "
                "persistent blocks (rows of A and "
                "B on 16-byte boundaries, K contiguous, or N contiguous for a bf16 B; timed here "
                "and on the int8 serving paths: generate_frames and lipsync_video, 51 a batch of "
                f"128 frames); packed: each operand no tensor map reads (a row-major int8 B, odd "
                "row strides, element strides, unaligned or broadcast views) copied to K-major "
                f"rows by {pkg}/csrc/int8_mm.cu (matmul_pack), then the same wgmma kernel "
                "(the microbench's int8 row-major B and int8_dense's (in,out) weight)")
        if name == "matmul_pack":
            kern["route_detail"] = (
                "K6's pack: a (rows, K) operand with any strides copied to rows of K contiguous "
                "elements, pad16(K size) bytes apart, in three paths picked by "
                "ops/matmul_cuda.pack_path: rows (K contiguous, any row start: aligned 16-byte "
                "words funnel-shifted into place), transpose (rows contiguous at 16-byte depth "
                "starts: tiles of 128 depths x 128 bytes through swizzled shared memory, byte "
                "permutes in registers; the 4096^2 row-major B timed here and in [microbench], "
                "int8_dense's (in,out) weight) and gather (element strides); every store 16 "
                "bytes; one launch a packed operand of the packed route")
        if kern["launches"] < 1:
            raise AssertionError(f"kernel {name} never ran on the main path")
        kernels.append(kern)
    log("main", f"all phases took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_name_power())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}), flush=True)


if __name__ == "__main__":
    main()
