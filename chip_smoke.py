#!/usr/bin/env python3
"""Drives the PyTorch port (vitlens_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each (or more); any failure exits non-zero:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
  2. build: compiles the hand-written kernels from vitlens_tpu_torch/csrc/
     (one nvcc per source, in parallel).
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the main paths and at edge shapes: fused MLP, both
     variants and both activations (out and the save-preact output a; bf16,
     <= 2.5e-2 and 1e-2 relative; also a ragged M = 4100, D/H = 768/3072
     and 1664/8192, the bigG text tower's 1280/5120 at M = 154, the
     PointTransformer's 384/1536 at M = 4104, and the plain variant at the
     video distill step's B64
     image tower, M = 131584), attention (bf16, <= 1e-2 relative; at the
     video Lens cross [64, 1, 256, 2048, 64], a ragged NK of 2040 beside it,
     the EEG and pc Lens cross [64, 1, 256, 512, 64], the PointTransformer's
     [8, 6, 513, 513, 64] and the distill step's
     image tower [512, 16, 257, 257, 64]; also every NQ, NK in
     {1, 7, 77, 257, 600}, NK past the K/V-resident limit, and the packed-qkv
     and Lens views bit-equal to contiguous copies; and head dims 32, 80,
     88, 96 (CoCa's pooler), 104, 112 and 128 at every NQ, NK in {1, 77,
     257, 600}, contiguous
     and on the packed-qkv views), fused LN + projection (bf16, <= 1e-2
     relative; ragged M at D/N 768/2304, 1024/3072 and 1664/4992, bigG's
     ragged N), FPS
     (index-exact, FPS_CASES: B in {1, 2, 64, 65, 133} and N in {1, 31,
     8192, 10000, 16384, 16385, 100000, 300000}, which cross every cluster
     size the wrapper picks (1 to 16) and every tier of a partition
     (registers, shared memory, global memory), npoint in {1, 512, N + 5}, zero and random
     starts, random clouds and clouds with exact ties: a lattice, duplicated
     points) and the point encoder (bf16, <= 2e-2 relative; at the pc
     path's [64, 512, 32] and at every group size M in {16, 32, 48, 64,
     128} with 21 groups, a count no tile size divides but 1; at M = 48,
     80 and 128 over more tiles than two a CTA, groups straddling its two
     consumers; at C4 = 384 and 512, conv4 in passes), the int8 product's
     INT32 epilogue (equal, at 4096^3, at the
     quantized encode's ragged M = 49344 and at an M that is not a multiple
     of 64), its DEQUANT epilogue (bit-equal to the plain dequantise of the
     same product, with and without bias, bf16 and fp32 output), the
     quantise kernel (bit-equal, the quantized encode's K at M = 49344 and a
     ragged M, rows with zeros, .5 ties and negative extremes) and
     quant.int8_matmul on the card bit-equal to its plain version, the row
     gather (bit-equal, [49408, 512] table, 9856 ids with repeated and
     boundary ids),
     the chained fused MLP with and without the out-projection (both
     activations, bf16, <= 2.5e-2 relative, D = 1024 at M = 16448 and a
     ragged M, D = 256 and 128), kernel 1's outputs at both of its
     activations bit-identical to the parent build's (KERNEL1_DIGESTS), and
     the fused LN + projection at the LN + qkv prototype's shape; then the
     gradients of each kernel-backed autograd Function
     (fused MLP, attention, LN + projection) against torch autograd of its
     plain version on the card, in bf16 (<= 2e-2 relative for the fused MLP
     and LN + projection, 1e-2 for attention), also at the CLIPBind step's
     shapes: the fused MLP at D 1664 / H 8192 (M = 16 x 257) and attention
     at head dim 104 in the bigG trunk [16, 16, 257, 257], the Lens cross
     [16, 1, 256, 512] and the Lens self [16, 16, 256, 256].
  4. slice: ViTLens("vitlensL", ("audio", "pc", "text")) at full ViT-L width
     and depth with random weights from a seeded CUDA generator, bf16
     compute, answers audio requests (B = 1, 4, 8, 3 clips each), point-cloud
     requests (B = 1, 4, 8 clouds of 8192 points, and one raw request of 2
     clouds of 9000 points through the host processor) and a text request.
     Every launch count is set to 0 just before each request and read just
     after it; checks shapes, finite values, unit norms, the launches per
     request (audio: 24 fused MLP + 32 attention; pc: 24 fused MLP + 32
     attention + 1 FPS + 1 point encoder; text: 12 fused MLP) and agreement
     (cosine >= 0.99) of the B = 1 audio and pc requests and the text request
     with the same weights moved to the CPU in fp32, where the plain versions
     run. The pc clouds are rounded through bf16 first, so that both runs give
     FPS the same coordinates; their FPS indices must be equal. Then the B = 1
     pc request again with the tokenizer's group size set to 24, which the
     point-encoder kernel does not take: the plain encoder runs (1 FPS, 0
     point-encoder launches) and the cosine against the CPU holds.
  4v. served from files: writes WAV files (16 kHz mono 5 s, 44.1 kHz stereo
     12 s, 8 kHz 1.5 s), a FLAC file (tools/reference_layout.py's writer),
     PNG and JPEG images (320 x 240, RGB and gray), .npy clouds of 9000
     points, disparity maps (.npy and a 16-bit .png), an EEG .pt [128, 500],
     a directory of 12 JPEG frames, and reference-layout checkpoints made
     from a seed by tools/reference_layout.py (a merged export with
     vitlens.{audio, pc, depth, eeg, video}. keys, a CLIP file with visual.
     and text keys; fp16). ViTLens("vitlensL", ("image", "tactile",
     "depth", "audio", "eeg", "video", "pc", "text"), checkpoints=...,
     batch_buckets=(1, 4, 8)) on the card in bf16 and the same in fp32 on
     the CPU: loaded tensors equal the files' after the cast; B = 1 encodes
     from files (and one B = 3 audio request: WAV, the 8 kHz WAV, the FLAC;
     one B = 2 depth request: the .npy and the .png) with the launches per
     request derived from the config (image, tactile and depth 24 fused MLP
     + 24 attention, EEG 24 + 26, video 24 + 28, audio 24 + 32, pc 24 + 32 +
     1 FPS + 1 point encoder, text 12) and cosine >= 0.99 against the CPU. The on-device fbank of
     [3, 80000] waveforms (the tower's waveform branch) against the host
     AudioProcessor's of the same samples: max |d| <= 1e-3 on the normalised
     fbank, tower features cosine >= 0.99. Then
     make_server(model, max_batch=8, max_wait_ms=50) answers 16 concurrent
     HTTP requests mixing the eight modalities (paths, a frame directory,
     captions, numeric pc items): each reply cosine >= 0.999 against a
     direct encode, fewer batches than requests, /healthz names the card and
     the eight modalities, both workers gone after shutdown and close.
     Last, `python -m vitlens_tpu_torch.cli.serve --modalities depth eeg
     video text --ckpt all=... --ckpt text=... --max-batch 2 --port 0`
     answers one request of each (cosine >= 0.999 against the in-process
     model's direct encode) and drains on SIGTERM with exit 0.
  4t. transformer Lens: a vitlensL depth tower whose Lens is 2 trunk-width
     blocks (as_transformer) at full width and depth, a B = 2 bf16 encode
     with 26 fused MLP + 26 attention launches and cosine >= 0.99 against
     the fp32 CPU copy.
  4f. fp32 default: ViTLens("vitlensL", ("audio", "pc", "text")) with its
     default compute dtype (fp32, as in JAX) encodes B = 2 of each on the
     card through the plain paths (the kernels take bf16, as JAX's gates
     send fp32 to XLA): no fused MLP, attention or point-encoder launch, one
     FPS launch per pc request; cosine >= 0.999 against the same model in
     fp32 on the CPU (the audio encode also with cuDNN's TF32 convolution
     off); the text encode on its own line.
  4h. head dims: bf16 B = 1 audio encodes at full width whose trunks have
     head dims other than 64, ViTLens("vitlensG", ("audio",)) (ViT-bigG-14,
     104) and a ViT-H-14 audio tower (80), each trunk cut to 4 blocks so that
     the CPU run stays short: launches derived from the config (4 fused MLP,
     4 + the Lens's attention), cosine >= 0.99 against the CPU in fp32.
  4g. vitlensG pc: ViTLens("vitlensG", ("pc", "text")) at full ViT-bigG-14
     width and depth (the first 16 of 48 trunk blocks skipped, as published)
     with the PNSA tokenizer over 10000 xyz + rgb points, bf16 compute and
     bf16 weights (the serve CLI's vitlensG setting), loaded from
     reference-layout fp16 checkpoints written by tools/reference_layout.py
     (a loaded PNSA weight and a skipped block's weight equal the file's);
     B = 1 and B = 2 encodes of raw .npy clouds of 10000 x 6 and of
     xyz-only clouds (the processor fills 0.4 grey), each with 1 FPS, 32
     fused MLP and 40 attention launches and no point-encoder launch
     (tower_launches), and a text request (32 fused MLP); cosine >= 0.99
     against the same weights in fp32 on the CPU, which gets the
     processor's clouds rounded through bf16 as the card sees them; then one
     HTTP request of two clouds and a caption through make_server, cosine
     >= 0.999 against the direct encodes.
  4q. quantized: the audio tower of that model quantized to int8 (W8A8) on
     the card by quant.quantize_model, at full width and depth: w_q and w_s
     made on the card equal to those made on the CPU; a B = 1 and a B = 64 x
     3 clips audio encode, each with 96 DEQUANT products and 96 quantise
     launches (4 x 24 blocks), 32 attention and no fused MLP or fused LN +
     projection launch, a text encode of the copy's float text tower (12
     fused MLP) and one of a copy whose text tower is quantized too (48 of
     each, no fused MLP); cosine >= 0.99 of the B = 1
     int8 encode against the same quantized weights in fp32 on the CPU and of
     both against the float bf16 encode on the card.
  4s. scripts: each bench entry point of vitlens_tpu_torch.scripts (the
     counterparts of the TPU prototypes' own main()) runs in this process at
     its own shapes with few iterations, must exit 0, and must launch its
     kernel.
  4b. train: the vitlensL audio+text model at full width and depth, fp32
     trainable masters, frozen weights in bf16, bf16 compute, with the
     published audio recipe (visual and text towers locked, CLS unlocked,
     dual loss aligned to text). The gradients of one B = 2 pass and one
     B = 2 step against the same on the CPU in fp32 (loss within 5e-2,
     grad_norm within 1e-1 relative, gradient cosine >= 0.99); 3 steps at
     B = 8, 2 at B = 8 with accum_freq 4 and one with remat, each with its
     launches per kernel variant against the count derived from the config;
     finite losses, every trainable parameter changed, every frozen one
     bit-identical.
  4c. opt-in: with VITLENS_ENABLE_FUSED_LNQKV=1 (set for this phase only), a
     B = 1 audio encode, a text encode and a train step launch the fused LN +
     projection 24 times per audio tower pass and 12 per text pass; the
     encode and the B = 2 gradients hold cosine >= 0.99 against the CPU fp32
     path.
  4d. tri train: the vitlensL depth model (create_model("ViT-L-14",
     "depth")) at full width and depth with its frozen ViT-L-14 image tower,
     fp32 trainable masters, frozen weights in bf16, bf16 compute, the
     published depth recipe (image, text and visual towers locked, the first
     4 trunk blocks unlocked, n_tower=3). The gradients of one B = 2 pass
     against the same pass on the CPU in fp32 (loss within 5e-2, grad_norm
     within 1e-1 relative, cosine >= 0.99); 3 steps at B = 8 and 2 with
     accum_freq 4, each with its launches per kernel variant against
     tri_train_launches (the image and text towers only kernel 1's plain
     variant, the Lens tower's trunk the save-preact one); every frozen
     parameter, the whole image tower included, bit-identical, every
     trainable one changed.
  4e. video distill: the vitlensL video model with video_distill=True and
     the distill-token loss (the image tower over the 8 frames of each clip,
     its features and tokens averaged over the frames, distilled into the
     video Lens tower; image, text and visual towers locked, so the Lens
     and the adapter train): the B = 2 gradients against the CPU in fp32,
     then 2 steps at B = 4 with accum_freq 2 (the cached tokens spliced in),
     with launches, frozen and trained checks as in 4d.
  4p. pc tri train: the vitlensL pc model (create_model("ViT-L-14", "pc"):
     the PointBERT tokenizer over 8192 points, the Lens of depth 4) at full
     width and depth with the published pc recipe (image, text and visual
     towers locked: the tokenizer and the Lens train, n_tower=3). The B = 2
     pass against the CPU fp32 pass as in 4d, FPS started at the same given
     points on both, the clouds rounded through bf16 once and the CPU pass
     given the card pass's kNN groups (bf16 distances, rounded as JAX's
     are, pick other neighbours than fp32 in most groups: the share is
     printed), with the
     moves of the tokenizer's BatchNorm running statistics held to the
     CPU's (cosine >= 0.99); 2 steps at B = 8 and 2 with accum_freq 4, FPS
     starts drawn from a CUDA generator, each with its launches against
     tri_train_launches (FPS once a pass that runs the tokenizer, the point
     encoder never: it is eval-only, as in JAX), the frozen and trained
     checks of 4d, and each BatchNorm run in train mode once a pass with
     its running statistics after the step those its accum_freq cached
     passes left (the grad passes' updates dropped).
  4x. train CLI: `python -m vitlens_tpu_torch.cli.train` as a child
     process on the card, the published vitlensL audio recipe (--n-tower 2
     --align-to text --unlock-cls --precision bf16, ViT-L-14 at full width
     and depth, B = 8, accum_freq 2) from files written here: 24
     AudioSet-style clips of 5-10 s (every fourth a FLAC, decoded by the
     native host library), an ESC50-style fold of 8 clips over 4 classes, an
     AudioCaps-style test set of 6 rows, and a reference-layout vitlensL tri
     file (fp16, tools/reference_layout.py) as --pretrained. Run (a): 2
     epochs, exit 0, a finite loss and grad_norm > 0 every step, val lines
     with ESC50 accuracy, AudioCaps r_mean and the primary metric, epoch_1,
     epoch_2, epoch_latest and checkpoint_best written. Run (b): --resume
     latest --epochs 3 continues at epoch 2 with the step count; every
     trainable tensor moved, every frozen one bit-identical to the
     pretrained file's after the bf16 cast. In this process, through
     cli.train's functions: the AdamW moments loaded from epoch_2 bit-equal
     to the file's; one train step (the batch through the DevicePrefetcher)
     with its launches against train_launches; one eval batch (8 x 3 clips)
     with tower_launches; checkpoint_best's eval features (loaded with
     load_checkpoint) cosine >= 0.99 against the same weights in fp32 on the
     CPU. Run (c): --visual-stat-flops prints its JSON line.
  4o. OpenShape: the vitlensG CLIPBind (train/openshape.py: PNSA over
     10000 xyz + rgb points, the bigG Lens, 16 of 48 trunk blocks skipped,
     out 1280) at full width, bf16 compute, fp32 masters, JAX's optimizer
     (clip 1.0, AdamW with optax's defaults, the ndim >= 2 decay mask, 0.1
     on the trunk): 3 steps at B16 on fixture triplets (every other cloud
     xyz-only), finite metrics, launches a step from tower_launches (32
     save-preact kernel 1, 40 kernel 2, 1 FPS), the skipped blocks at p *
     prod(1 - lr_t * wd * 0.1) (their moments 0), logit_scale moved, an
     eval batch (32 plain kernel 1, 40, 1) and the peak memory; the B = 2
     gradients of a bigG-width tower of 8 trunk blocks (4 skipped) and a
     Lens of depth 1, bf16 on the card against fp32 on the CPU (cosine >=
     0.99, the CPU given the card's ball-query groups); the baselines at
     the CLI's widths in fp32 (PointBERT/PPAT, DGCNN and PointNet at
     scaling 3): a train step each at B16 (FPS once for PPAT), a B = 2
     forward against the CPU from the same starts and groups (1e-3 without
     TF32), a PointNet2 forward (2 FPS launches); the PointTransformer
     (8192 points, 12 blocks) in bf16 eval at B8 (1 FPS, 1 point encoder,
     12 kernel 1, 12 kernel 2; cosine >= 0.99 against fp32 on the CPU);
     then `python -m vitlens_tpu_torch.cli.train_openshape` at full width
     in this process on 32 fixture triplets at --batch-size 16: one epoch
     with eval, --resume latest to epoch 2 (from the file's weights, the
     optimizer's count restarted), eval-only from epoch_latest, with
     launches, checkpoints, meta.json epochs and eval keys checked, the
     free disk and the bytes written printed. Its phase-5 timings (the
     CLIPBind step's rate, peak and profile with kernel 2's share, each
     baseline's step, the PointTransformer encode at B64, the CLI's step
     seconds) run inside the phase, on its models.
  4ev. EVA-g: the Perceiver-EVA pc tower of vitlensG's MLLM plug-in at full
     width and depth (models.eva.make_eva_tower: PointBERT over 8192
     points, a Perceiver of depth 4 over 256 latents of 1408, 39 EVA blocks
     of 1408 with 16 heads of 88, MLP 6144, LayerNorm eps 1e-6, head to
     1024), random weights from a seeded CUDA generator, bf16: B16 and B64
     encodes with launches exactly tower_launches(cfg) (39 kernel 1, 47
     kernel 2, 1 FPS, 1 point encoder); a B = 2 encode against the same
     weights in fp32 on the CPU (clouds rounded through bf16, the card's kNN
     groups replayed), cosine >= 0.99; B16 and B64 rates, peak memory and a
     profile. Phase 3 holds kernel 1 at D 1408 / H 6144 with eps 1e-6 (M =
     16 x 257 and 64 x 257, both variants; gradients at the smaller) and
     kernel 2 at [64, 16, 257, 257, 88], [64, 22, 256, 256, 64] and the RN50
     pool [64, 32, 50, 50, 64] (gradients at head dim 88); phase 5 times
     them beside their bounds, the plain versions and SDPA or cuBLAS.
  4l. LoRA: the vitlensL audio+text model with rank-8 factors on the four
     targets of the audio trunk, the factors alone trained (the trainer's
     --lora-* recipe), bf16 compute, the b's drawn nonzero: a B = 2
     gradient pass and step against the same model in fp32 on the CPU (loss,
     cosine of the a's and the b's gradients >= 0.99, grad_norm), then 3
     steps at B = 8 with train_launches' counts, every base weight bit-equal
     and every factor moved; the tower in a ViTLens: export_checkpoint holds
     merged weights (their change from the base ones = scale * a @ b,
     computed apart) and no factor, a second model with its own factors
     reloads it (b's zeroed) to the same encode, quant.quantize_model
     refuses the unmerged tower.
  4rb. RoBERTa: create_model("roberta-ViT-B-32", "image") at full width,
     bf16: the text tower on token ids given directly (no launch: post-LN,
     masked) and the image tower (12 + 12 launches), cosine >= 0.99 against
     fp32 on the CPU; the text B64 rate.
  4r. RN50: models.resnet.make_modified_resnet("RN50") at 224, bf16, one
     attention launch a forward, cosine >= 0.99 against fp32 on the CPU;
     the B64 rate.
  4lp. linear probe: `python -m vitlens_tpu_torch.cli.train_linprobe` as a
     child process on written GelSight frames at full ViT-L width, B = 8,
     2 epochs of LARS steps and an eval each; exit 0, an accuracy a val
     epoch, the step seconds printed.
  4i. infer: `python -m vitlens_tpu_torch.cli.infer --precision bf16` as a
     child process on WAV, .npy and PNG files and captions: the printed
     matrices' rows sum to 1 and equal the API's encode in this process.
  4ex. export: utils.export.export_encoder of the vitlensL audio tower in
     bf16, load_exported; the loaded program's run advances the kernels'
     counters by tower_launches and equals the eager encode; the host cost
     a call of the custom ops against the wrappers' own dispatch.
  4co. CoCa: models.coca.make_coca("coca_ViT-L-14") at full width and depth
     (0.64 B parameters) in bf16 against the same weights in fp32 on the
     CPU: a B = 2 encode and forward (captions with a pad tail; cosine of
     the image and text features and the caption logits >= 0.999, the
     contrastive and caption losses within 1e-2 relative), a B = 2 backward
     of their sum on fp32 masters (gradient cosine >= 0.99 on the pooler,
     the decoder's cross blocks and the vision trunk's last block), beam
     search (6 beams, 3 groups, seq_len 20) twice: identical, SOT first,
     pad after the end; width-1 beam equal to top_k=1 sampling up to the
     first EOS or top-logit tie; the card's tokens teacher-forced on the
     CPU (width-1 beam: the CPU's argmax or within 0.05 of its max; beam
     search: within 0.05 of the CPU's top 4, the width a step draws from);
     launches of the encode, forward and beam search as coca_launches
     derives them. coca_ViT-B-32 at full width: a B = 2 encode and forward,
     cosines and launches. Then the L-14 image encode at B64, the forward +
     backward at B16 (every parameter an fp32 master) and beam-search
     captions at B = 8 (seq_len 30), with profiles of the forward +
     backward and of a seq_len-10 captioning.
     Phase 3 holds kernel 2 at CoCa's shapes first: the L-14 pooler's head
     dim 96 (forward and gradients), the B-32 pooler's 50 keys, the
     decoder's cross shapes (NQ 1, 29, 76 by NK 256, 257, 12 and 8 heads;
     on the cross block's views, bit-equal to contiguous copies; gradients
     at [12, 12, 76, 256, 64]), and a broadcast query (batch stride 0)
     refused by the wrapper, its contiguous copy within bound.
  4dp. data parallel (vitlens_tpu_torch/parallel/mesh.py): (a) inside phase
     5, a world-size-1 NCCL group on a localhost store, and phase 4b's B64
     audio step through make_train_step(mesh=make_mesh()) against the
     mesh=None step from the same state and batch (loss, grad_norm, every
     gradient and updated parameter within 1e-6 relative; launches as
     train_launches); (b) after phase 5, two rank processes sharing the
     card over gloo (NCCL refuses two ranks on one device; `python3
     chip_smoke.py --dp-rank DIR` is a rank), each running the audio step
     and the pc tri step with synced BatchNorm and pinned FPS starts at
     B32, rank 0 then the B64 steps on the whole batch (plain, accum_freq
     2, and the halves swapped): loss within 1e-3 relative, the gradient
     cosine a trainable group (audio: >= 0.999 against accum_freq 2, whose
     passes have the ranks' shapes; both: >= COS_MIN and the one-process
     floor less 2e-3 against the plain B64 step), grad_norm within 1e-2
     relative (the cosine cannot see a factor of world in the gradients),
     each BatchNorm running statistic within 1e-4 relative (unsynced
     BatchNorm normalises over 32 rows), launches as train_launches and
     tri_train_launches, and each rank's peak memory; (c) ViTLens("vitlensL",
     ("audio", "text"), mesh=make_mesh(devices=["cuda:0", "cuda:0"]))
     against one device (B = 5 audio requests, padded to 6, and 3
     captions: cosine >= 0.9999, launches twice a chunk's) and a served
     closed loop on the --data-parallel 1 mesh of the serve CLI. (b)'s
     audio and pc recipes (and so 4fs (b) and (c)) cut the Lens trunk to
     CUT_DEPTH (12) of its 24 blocks, for time.
  4fs. FSDP (vitlens_tpu_torch/parallel/fsdp.py, FSDP2): (a) inside 4dp
     (a)'s group, the same B64 audio step with partition="fsdp" after
     fsdp_place (FSDP2 over one rank) against the mesh=None step: every
     gradient and updated parameter within 1e-6 relative, launches as
     train_launches; (b) in 4dp (b)'s rank processes, after each rank's DP
     step, the FSDP step from the same state on the same rows (the audio
     step and the pc tri step, BatchNorm over both ranks' rows, the global
     batch's FPS starts) against that DP step: loss, grad_norm, every
     gradient and updated parameter (gathered) within 1e-5, each BatchNorm
     statistic within 1e-5 relative, launches equal; each rank's bytes of
     parameters + moments against the DP step's and the placements' count,
     and the FSDP step's peak; (c) the audio FSDP state saved collectively
     (DCP), reloaded into the two ranks and into one process, unsharded,
     bit for bit. `python3 tools/dp_first_call.py --fsdp --plant` runs (b)
     under three planted faults, each of which must fail it. (b) also runs
     phase 4l's LoRA recipe (attach_lora_: vitlensL audio + text, rank 8 on
     the four targets of the 24-block audio trunk, the b's drawn nonzero,
     the factors alone trained, bf16 with fp32 masters) as a third recipe
     of 4dp (b): its DP step against the one-process B64 step (the audio
     recipe's bars: the floor less 2e-3), its FSDP step against that DP
     step (FS_REL; whether bit-equal printed), every base weight bit-equal
     after the step and every factor moved, the bytes and peaks a rank.
  4tp. the model axis (vitlens_tpu_torch/parallel/tp.py, sp.py, the 2D
     state of fsdp.py): after 4dp/4fs, four rank processes sharing the card
     over gloo, laid out [data 2, model 2] by make_mesh(n_model=2) (`python3
     chip_smoke.py --tp-rank DIR` is a rank). (a) ViTLens("vitlensL",
     ("audio",)) in bf16, B = 8 requests of 3 clips, each data row a [data
     1, model 2] pair: the one-process encode, then under
     sequence_sharded_activations (SP: kernel 2 on the rank's query rows
     against every key, kernel 1 on its rows), split by shard_vision_tower
     (TP: kernel 2 on the rank's 8 heads, the MLP plain as in JAX) and both;
     cosine >= 0.9999 against the one process, launches a rank as
     tower_launches(tp=) derives them; the trunk's out_b drawn from the seed
     (MHA's init zeroes it); (a)'s trunk is cut to CUT_DEPTH (12) of its
     24 blocks, for time. (b) the audio + text step with the whole audio
     tower trained, B32 global (B16 a data rank), after fsdp_tp_place:
     bf16 TP and TP + SP against the one-process B32 step (loss 1e-3,
     grad_norm 1e-2 relative, each group's gradient cosine >= COS_MIN and
     the one-process bf16 floor, B32 against accum_freq 2, less 2e-3), fp32
     TP (with remat) against the fp32 step (every group's cosine >= 0.999);
     launches as train_launches(tp=True), equal metrics on every rank, each
     rank's audio trunk bytes half the whole, the peaks. `python3
     tools/dp_first_call.py --tp --plant` runs it under two planted faults,
     each of which must fail (b). Then (b)'s LoRA variant: phase 4l's
     factors on the split audio trunk (whole on each model rank, FSDP over
     data), the factors alone trained, TP in bf16 (the floor less 2e-3)
     and fp32 with remat (cosine >= 0.999), launches as
     train_launches(tp=True): kernel 2 on the rank's heads, no kernel 1 in
     a split block.
  4pp. pipelining (vitlens_tpu_torch/parallel/pp.py), in 4tp's four rank
     processes after 4tp (b) (`python3 chip_smoke.py --pp-rank DIR` is a
     rank of 4pp alone). (a) ViTLens("vitlensL", ("audio",)) in bf16, B = 8
     requests of 3 clips, placed by pipeline_place and encoded under
     pipelined_trunks on [data 1, pipe 4] (M = 4) and [data 2, pipe 2] (M =
     2, each data row its 4 requests): cosine >= 0.9999 against the
     one-process encode, launches a rank as tower_launches(pp=) derives
     them, each rank's trunk bytes 1 / stages of the whole; (b) the vitlensG
     pc encode at B16 (32 of 48 bigG blocks run, 8 a stage on [data 1, pipe
     4], M = 4; the 16 skipped blocks dropped): the same bars, FPS once,
     each rank's bytes of the blocks that run a quarter of the 32's, the
     peaks; (c) the gradient of the audio x text contrastive loss at B16
     through the pipelined audio tower (its trunk cut to CUT_DEPTH (12)
     blocks for time, 3 a stage; the whole tower trainable; the text
     tower's 12 blocks pipeline too) on [data 1, pipe 4], M = 4, against
     one process: fp32 with remat (every group's cosine >= 0.999, the loss
     within 1e-4 relative), bf16 (each group's cosine >= COS_MIN and the
     one-process floor at the microbatches' shapes, B16 against accum_freq
     4, less 2e-3); the stages' blocks gathered to rank 0, the replicated
     gradients equal on every rank; launches a rank as pp_grad_launches
     derives them. Then (c)'s LoRA variant: phase 4l's factors on the audio
     and the text trunk, the factors alone trained, both towers placed and
     pipelined (M = 4): two trained towers in one backward, held to one
     process's passes as (c) is. Host ms of the pipelined encodes beside
     the one process's. `python3 tools/dp_first_call.py --pp --plant` runs
     it under two planted faults, each of which must fail it. `python3
     tools/dp_first_call.py --lora` runs the LoRA sub-phases of 4fs (b), 4tp
     (b) and 4pp (c) alone (`--dp-rank --lora`, `--tp-rank --lora`).
  5. timing: each kernel against its plain version (and, where one PyTorch
     call computes the same function, that call) at the B64 shapes of the
     main paths, beside each kernel's bound, with cuBLAS's products alone
     (torch.addmm on the normalised input) beside the fused MLP, the
     chained MLPs (two, and three with the out-projection) and the fused LN
     + projection, the trunk attention also on the packed-qkv views; kernel
     2 at CoCa's pooler [64, 8, 257, 257, 96], B-32 pooler [64, 8, 257, 50,
     64] and decoder cross [64, 12, 76, 256, 64] shapes beside SDPA; the audio (64 samples x 3 clips)
     and pc (64 clouds) encode rates at B64 in bf16, the audio encode also
     with the opt-in; the audio train-step rate at B64 with and without the
     opt-in, with the peak device memory; the 4d depth tri step's rate at
     B64, the 4e video distill step's and the 4p pc tri step's at the
     largest B in (64, 32) that fits, each with its peak device memory and
     one step under the profiler (busy and idle share); the 4g vitlensG pc
     encode at B16 (arrays given) with its peak memory and a profile, and
     the ball query at its shape [16, 512, 10000], 64 a ball, beside its
     bound; attention at the bigG trunk's
     head dim 104 beside SDPA; the int8 product's INT32 and DEQUANT
     epilogues at 4096^3 and the quantized encode's four shapes beside
     torch._int_mm, the quantise kernel beside its bound, the row gather's
     device time and, through its wrapper, its time back to back and host
     time a call, beside index_select's, the chained MLPs beside the
     three-launch fused MLP on the same function and today's split; FPS at
     B64 and B = 1 (N 8192, npoint 512); the host-timed latency of a B = 1 pc
     encode; the B64 quantized audio encode rate
     beside the float one; a torch.profiler breakdown of one B64 audio (float
     and quantized) and one B64 pc encode and one B64 train step with the
     device's busy and idle share; the Lens-cross attention of video [64, 1,
     256, 2048, 64] and of EEG and pc [64, 1, 256, 512, 64] beside SDPA;
     the served path (phase 4v's model): the B64 image, depth, EEG and video
     encode rates (arrays given; a profile of the video encode), the host
     AudioProcessor per 10 s WAV, ImageProcessor per image, DepthProcessor
     per .npy and per .png, EEGProcessor per .pt and VideoProcessor per
     12-frame directory, the on-device fbank at [192, 80000], and a
     closed-loop served run (64 audio requests of one 5 s WAV from 16 client
     threads at max_batch 64: requests/s, p50 and p95 from /healthz); the
     native host library: PointCloudProcessor on raw .npy clouds of 9000
     and 10000 points (FPS through the library) beside the plain numpy FPS
     loop, a 10 s FLAC decoded by the library beside the pure-Python
     decoder, and the closed loop again with one 5 s FLAC a request; phase
     4x's train step (host-timed) and the host ms a clip of its AudioSet
     pipeline. Every time is printed beside the card's name and power
     limit.
The last lines are {"kernels": [...]}, the card's name and power limit, then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time

MLP_TOL = 2.5e-2   # bf16 rounding; the kernel keeps the act input in fp32
PREACT_TOL = 1e-2  # a: the kernel adds b1 in fp32, the plain version in bf16
ATTN_TOL = 1e-2    # bf16 P in the P @ V product, fp32 everywhere else
LNP_TOL = 1e-2     # bf16 LN output and product; only sum order differs
ENC_TOL = 2e-2     # bf16 rounding; rounding points that differ by one ulp
# Gradients of the Functions against autograd of the plain versions, bf16:
# the intermediate gradients (dh, da, dy) round to bf16 at other points in
# the closed-form backward than in autograd, and dW, db, dLN sum ~1000 rows
# (the first H100 run read at most 6.9e-3).
GRAD_TOL = 2e-2
ATTN_GRAD_TOL = 1e-2  # both recompute P in fp32; only the rounding of dq/dk/dv
CHAIN_TOL = 2.5e-2  # as the fused MLP: bf16 roundings of z, h and out
COS_MIN = 0.99     # bf16 card path against the fp32 CPU plain path
LOSS_TOL = 5e-2    # |loss card - loss CPU|: bf16 features at logit scale 14.3
# grad_norm card / CPU - 1: bf16 gradients; a cosine of 0.99 alone allows
# ~14%, the ViT-Tiny rehearsal on the CPU read 2%
NORM_TOL = 1e-1
SEED = 0
B = 64             # the benchmark batch of both encode paths

# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet, dense rates).
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_INT8 = 1979e12
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


def abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain, iters: int = 20, plain_iters: int = 20):
    """Mean kernel and plain times over the order plain, kernel, kernel,
    plain, so that drift over the window falls on both sides alike."""
    p1 = cuda_ms(plain, plain_iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(ops: float, nbytes: float, peak: float):
    """The least time (ms) the card could take: the larger of the operations
    over the peak rate and the bytes (each input read once, each output
    written once) over the memory rate; and which of the two it is."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mlp_bound(m, d, h):  # x, out, W1, W2 bf16; LN params and biases fp32
    return bound(4 * m * d * h, 2 * (2 * m * d + 2 * d * h) + 4 * (3 * d + h),
                 PEAK_BF16)


def attn_bound(b, h, nq, nk, dh):  # q, k, v, out bf16
    return bound(4 * b * h * nq * nk * dh, 2 * b * h * dh * (2 * nq + 2 * nk),
                 PEAK_BF16)


def preact_bound(m, d, h):  # the save-preact variant also writes a [M, H] bf16
    return bound(4 * m * d * h,
                 2 * (2 * m * d + 2 * d * h + m * h) + 4 * (3 * d + h), PEAK_BF16)


def ln_proj_bound(m, d, n):  # x, out, W bf16; LN params and bias fp32
    return bound(2 * m * d * n, 2 * (m * d + m * n + d * n) + 4 * (2 * d + n),
                 PEAK_BF16)


def fps_bound(b, n, npoint):
    # per distance update (npoint - 1 of them) and point: 3 sub, 3 mul, 2 add,
    # min, compare (fp32 cores)
    return bound(10 * b * n * (npoint - 1), 12 * b * n + 4 * b + 4 * b * npoint,
                 PEAK_FP32)


def enc_bound(bg, m, c1, c2, c3, c4):
    ops = (2 * bg * m * (3 * c1 + c1 * c2 + c2 * c3 + c3 * c4)
           + 2 * bg * c2 * c3)
    nbytes = (2 * bg * m * 3 + 2 * bg * c4
              + 2 * (3 * c1 + c1 * c2 + 2 * c2 * c3 + c3 * c4)
              + 4 * (4 * c1 + c2 + 4 * c3 + c4))
    return bound(ops, nbytes, PEAK_BF16)


def int8_bound(m, k, n):  # a, b int8 read once; the int32 product written once
    return bound(2 * m * k * n, m * k + k * n + 4 * m * n, PEAK_INT8)


def dequant_bound(m, k, n):
    """a, b int8 read once; row scales, column scales and bias fp32; the
    bf16 output written once."""
    return bound(2 * m * k * n, m * k + k * n + 4 * m + 8 * n + 2 * m * n,
                 PEAK_INT8)


def quantize_bound(m, k, elem_bytes):  # x read once; int8 rows, fp32 scales
    return bound(0, m * k * elem_bytes + m * k + 4 * m, PEAK_BF16)


def gather_bound(j, row_bytes):  # J rows read and written, J int32 ids
    return bound(0, 2 * j * row_bytes + 4 * j, PEAK_BF16)


def chain_bound(m, d, h, outproj):  # as mlp_bound, plus ctx, Wo and bo
    extra_ops, extra_bytes = (2 * m * d * d, 2 * (m * d + d * d) + 4 * d) \
        if outproj else (0, 0)
    return bound(4 * m * d * h + extra_ops,
                 2 * (2 * m * d + 2 * d * h) + 4 * (3 * d + h) + extra_bytes,
                 PEAK_BF16)


def int8_inputs(torch, g, m, k, n):
    """a [M, K], b [K, N] and b transposed, random in [-127, 127]."""
    a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                      dtype=torch.int8)
    return a, b, b.t().contiguous()


def outproj_inputs(torch, g, m, d):
    def r(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    return (r(m, d, std=0.5), r(d, d, std=d ** -0.5),
            r(d, std=0.1, dtype=torch.float32))


def mlp_inputs(torch, g, m, d, h):
    def r(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    f32 = torch.float32
    return (r(m, d, std=0.5), 1.0 + r(d, std=0.1, dtype=f32),
            r(d, std=0.1, dtype=f32), r(d, h, std=d ** -0.5),
            r(h, std=0.1, dtype=f32), r(h, d, std=h ** -0.5),
            r(d, std=0.1, dtype=f32))


def fps_inputs(torch, g, b, n, cloud="random", starts="zero"):
    """xyz [b, n, 3] fp32 on the card and start [b] int32 (zero or uniform
    in [0, n)). Clouds: "random" (normal, std 0.3); "lattice" (a 16 x 16 x k
    grid of step 0.125 in point order, so that equal distances meet inside a
    warp, across warps and across the cluster's partitions); "duplicates"
    (37 distinct points repeated, so that every distance reaches 0 and index
    0 repeats once the 37 are taken)."""
    i = torch.arange(n, device="cuda")
    if cloud == "random":
        xyz = torch.randn(b, n, 3, generator=g, device="cuda") * 0.3
    elif cloud == "lattice":
        grid = torch.stack((i % 16, (i // 16) % 16, i // 256), -1).float() * 0.125
        xyz = grid.expand(b, n, 3).contiguous()
    else:
        base = torch.randn(b, 37, 3, generator=g, device="cuda")
        xyz = base[:, i % 37].contiguous()
    start = (torch.randint(0, n, (b,), generator=g, device="cuda", dtype=torch.int32)
             if starts == "random" else torch.zeros(b, dtype=torch.int32, device="cuda"))
    return xyz, start


# (B, N, npoint, cloud, starts) of phase 3's FPS checks; the first two are
# timed in phase 5.
FPS_CASES = ((B, 8192, 512, "random", "zero"), (1, 8192, 512, "random", "zero"),
             (1, 1, 1, "random", "zero"), (2, 1, 6, "random", "zero"),
             (2, 31, 36, "random", "random"), (65, 31, 1, "random", "random"),
             (65, 10000, 512, "random", "random"),
             (133, 16384, 512, "random", "zero"),
             (64, 16385, 512, "random", "random"),
             (2, 16385, 512, "lattice", "random"),
             (1, 100000, 512, "random", "random"),
             (1, 300000, 64, "random", "random"),
             (64, 100000, 64, "random", "zero"),
             (133, 100000, 16, "lattice", "random"),
             (1, 8192, 512, "lattice", "zero"), (B, 8192, 512, "lattice", "random"),
             (65, 10000, 512, "duplicates", "random"),
             (2, 31, 36, "duplicates", "zero"),
             (133, 8192, 512, "duplicates", "zero"))


# sha256 (first 16 hex digits) of kernel 1's outputs on kernel1_digests'
# inputs, from the build of the parent commit on an H100: the tanh GELU added
# to gemm_sm90.cuh's act_fn (for the chained MLPs) leaves acts 0 and 1
# bit-identical.
KERNEL1_DIGESTS = {
    "gelu": ("8ea59f0450c38bb8", "8ea59f0450c38bb8", "b202cffe3b1788aa"),
    "quick_gelu": ("9a789c45de3cbca6", "9a789c45de3cbca6", "b202cffe3b1788aa")}


def kernel1_digests(torch, np):
    """Digests of kernel 1's outputs (out of the plain variant, out and a of
    the save-preact variant) at acts 0 and 1 on inputs made with numpy from
    SEED, [1001, 1024] x [1024, 4096]."""
    import hashlib

    from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_save_preact

    rng = np.random.RandomState(SEED)
    m, d, h = 1001, 1024, 4096
    arrays = (rng.randn(m, d) * 0.5, 1 + 0.1 * rng.randn(d), 0.1 * rng.randn(d),
              rng.randn(d, h) * d ** -0.5, 0.1 * rng.randn(h),
              rng.randn(h, d) * h ** -0.5, 0.1 * rng.randn(d))
    args = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in arrays]
    for i in (0, 3, 5):
        args[i] = args[i].bfloat16()

    def digest(t):
        return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]

    out = {}
    for act in ("gelu", "quick_gelu"):
        y = fused_mlp(*args, act=act)
        y2, a = fused_mlp_save_preact(*args, act=act)
        out[act] = (digest(y), digest(y2), digest(a))
    return out


def ln_proj_inputs(torch, g, m, d, n):
    def r(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    f32 = torch.float32
    return (r(m, d, std=0.5), 1.0 + r(d, std=0.1, dtype=f32),
            r(d, std=0.1, dtype=f32), r(d, n, std=d ** -0.5),
            r(n, std=0.1, dtype=f32))


def qkv_inputs(torch, g, b, h, nq, nk, d=64):
    return tuple(torch.randn(b, h, n, d, generator=g, device="cuda")
                 .to(torch.bfloat16) for n in (nq, nk, nk))


def quant_rows(torch, g, m, k, dtype):
    """Activations whose rows hold the quantise step's edge cases: an
    all-zero row (the 1e-12 floor), a row of exact .5 ties (amax 127, so the
    row scale is 1), a row whose extremes are negative, and random rows of
    three magnitudes."""
    x = torch.randn(m, k, generator=g, device="cuda")
    x = x * torch.tensor([1e-3, 1.0, 40.0], device="cuda")[
        torch.randint(0, 3, (m, 1), generator=g, device="cuda")]
    x[0] = 0
    if m > 1:
        x[1] = torch.tensor([127.0, -0.5, 0.5, 1.5, 2.5, -1.5, -2.5, 3.5],
                            device="cuda").repeat(k // 8)
    if m > 2:
        x[2] = -x[2].abs() * 3
    return x.to(dtype)


def device_ms(torch, fn, iters=50):
    """The device time a call of ``fn``: the kernels it launches, summed by
    the profiler over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / iters


def host_us(torch, fn, iters=300):
    """The host time a call of ``fn`` takes to enqueue its work (the card
    keeps up where the device time is the shorter)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


ENC_WIDTHS = (128, 256, 512, 256)  # the PointBERT encoder's C1..C4


def enc_inputs(torch, g, bg_shape, m, c4=ENC_WIDTHS[3]):
    """Group points [..., M, 3] bf16 and encoder weights with nontrivial BN
    statistics, in the wrapper's argument order; C4 is the tokenizer's
    encoder_dims."""
    c1, c2, c3 = ENC_WIDTHS[:3]

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def bn(n):
        return (r(n, std=0.2), 0.5 + r(n).abs(), 1.0 + r(n, std=0.2),
                r(n, std=0.1))

    nb = r(*bg_shape, m, 3, std=0.1).bfloat16()
    return (nb, r(3, c1, std=0.5).bfloat16(), r(c1, std=0.1), bn(c1),
            r(c1, c2, std=c1 ** -0.5).bfloat16(), r(c2, std=0.1),
            r(2 * c2, c3, std=(2 * c2) ** -0.5).bfloat16(), r(c3, std=0.1),
            bn(c3), r(c3, c4, std=c3 ** -0.5).bfloat16(), r(c4, std=0.1))


def grad_errs(torch, g, function, plain, args):
    """Relative errors of the gradients of ``function`` (a kernel-backed
    autograd Function) against torch autograd of ``plain`` on the same
    inputs and output gradient, one per input."""
    def run(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        out = fn(*leaves)
        cot = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
        return out, torch.autograd.grad(out, leaves, cot)

    state = g.get_state()
    out, got = run(function)
    if "Function" not in type(out.grad_fn).__name__:
        fail(f"{function.__name__}: autograd did not record its Function")
    g.set_state(state)  # the same output gradient for both
    _, want = run(plain)
    return [rel_err(a, b) for a, b in zip(got, want)]


COUNTED = ("fused_mlp", "fused_mlp_save_preact", "flash_attention", "fps",
           "point_encoder", "fused_ln_proj", "int8_matmul", "int8_matmul_dequant",
           "int8_quantize", "row_gather", "fused_mlp_chunked", "fused_attnout_mlp")


def launch_counts(**counts):
    """Expected launches by counter: the named ones, every other 0."""
    return {**dict.fromkeys(COUNTED, 0), **counts}


def tower_launches(cfg, tp=False, pp=None, **more):
    """Expected launches of one bf16 encode of a vision tower, derived from
    its config: kernel 1 and kernel 2 once a trunk block that runs (the
    first skip_first_n_layers are skipped); a Perceiver Lens adds one
    attention a cross and a self block; a transformer Lens adds its blocks'
    MLP and attention; the identity Lens adds nothing. ``tp``: the trunk
    split over a model axis (parallel.tp), whose blocks' MLP is plain, as
    in JAX (attention still once a block, on the rank's heads); sequence
    parallelism alone changes no count (each kernel runs on the rank's
    rows). ``pp``: (stages, microbatches) of a trunk pipelined on a rank
    (parallel.pp): its blocks run (layers - skip) / stages times a
    microbatch, the bubble ticks none."""
    p = cfg.perceiver
    mlp = attn = cfg.arch.layers - (cfg.skip_first_n_layers or 0)
    if pp is not None:
        mlp = attn = mlp // pp[0] * pp[1]
    if tp:
        mlp = 0
    if p is not None and p.as_transformer:
        mlp, attn = mlp + p.depth, attn + p.depth
    elif p is not None and not p.as_identity:
        attn += p.depth * (1 + p.self_per_cross_attn)
    return launch_counts(fused_mlp=mlp, flash_attention=attn, **more)


def coca_launches(cfg, what, steps=0):
    """Expected launches of a bf16 CoCa call, derived from its config: an
    image encode (``what="encode"``) runs kernel 1 once a vision block and
    kernel 2 once a vision block and once in the pooler; the forward adds
    kernel 1 once a text and a decoder self block and kernel 2 once a
    decoder cross block (the text tower's and the self blocks' attention are
    masked, the cross blocks' MLP plain); a generate (``what="generate"``)
    is one encode and ``steps`` decodes of the text tower and the decoder."""
    v, t, m = cfg.vision.layers, cfg.text.layers, cfg.multimodal.layers
    if what == "encode":
        return launch_counts(fused_mlp=v, flash_attention=v + 1)
    if what == "forward":
        return launch_counts(fused_mlp=v + t + m, flash_attention=v + 1 + m)
    if what == "generate":
        return launch_counts(fused_mlp=v + steps * (t + m),
                             flash_attention=v + 1 + steps * m)
    raise ValueError(what)


def train_launches(cfg, text_layers, accum, remat, opt_in, tp=False):
    """Launches per kernel variant of one train step of the dual audio+text
    recipe, derived from the config: each pass with grad runs the audio
    trunk through the save-preact variant (twice under remat: the block is
    recomputed in the backward) and the frozen text tower through the plain
    one; accum_freq > 1 adds a cached pass of both towers without grad.
    Attention: the trunk's blocks and the Lens's cross and self blocks (the
    text tower's causal attention is plain). ``tp``: the audio trunk split
    over a model axis, its MLP and its LN + qkv plain (kernel 2 only)."""
    la, lt = cfg.arch.layers, text_layers
    lens = cfg.perceiver.depth * (1 + cfg.perceiver.self_per_cross_attn)
    cached = accum if accum > 1 else 0
    r = 2 if remat else 1
    lk = 0 if tp else la  # trunk blocks that launch kernels 1 and 6
    return launch_counts(
        fused_mlp=accum * lt + cached * (lk + lt),
        fused_mlp_save_preact=accum * lk * r,
        flash_attention=accum * (la * r + lens) + cached * (la + lens),
        fused_ln_proj=(accum * (lk * r + lt) + cached * (lk + lt)
                       if opt_in else 0))


def train_phase(torch, np, counters, totals):
    """Phases 4b and 4c: the audio train step of the published recipe on
    the card, against the CPU in fp32. Returns what phase 5 times."""
    from dataclasses import replace

    from vitlens_tpu_torch.factory import create_model, make_trainable_
    from vitlens_tpu_torch.models import tri
    from vitlens_tpu_torch.train.freeze import count_trainable, tri_model_mask
    from vitlens_tpu_torch.train.losses import make_loss_fn
    from vitlens_tpu_torch.train.step import (OptimizerConfig, StepConfig,
                                              init_train_state, make_optimizer,
                                              make_train_step, micro_grads)

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        """The launches since reset(), added to the main-path totals."""
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counters.items()}
        for name, n in counts.items():
            totals[name] += n
        return counts

    t0 = time.time()
    model = create_model("ViT-L-14", "audio", seed=SEED, device="cuda",
                         dtype=torch.float32)
    cfg = model.cfg
    acfg, n_text = cfg.tower, cfg.text.layers
    mask = tri_model_mask(model, cfg, lock_visual=True, lock_text=True,
                          unlock_cls=True)
    tx, mask = make_optimizer(model, OptimizerConfig(
        lr=1e-4, warmup=10, total_steps=1000, grad_clip_norm=1.0), mask)
    make_trainable_(model, mask, torch.bfloat16)
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    names = [n for n, t in mask.items() if t]
    rng = np.random.RandomState(SEED)

    def batch(b):
        text = rng.randint(1, 49000, size=(b, 77))
        text[:, 0], text[:, -1] = 49406, 49407
        fb = rng.randn(b, acfg.audio.target_length, acfg.audio.mel_bins) * 0.5
        return {"text": torch.from_numpy(text).long(),
                "visual": torch.from_numpy(fb.astype(np.float32))}

    sc = StepConfig(n_tower=2, align_to="text", compute_dtype=torch.bfloat16)
    sc_cpu = replace(sc, compute_dtype=torch.float32)
    loss_fn = make_loss_fn(2)

    def grads_of(m, step_cfg, bt):
        params = {n: p for n, p in m.named_parameters() if mask[n]}
        dev = m.logit_scale.device
        loss, gr = micro_grads(m, {k: v.to(dev) for k, v in bt.items()},
                               step_cfg, params, loss_fn)
        return float(loss), torch.cat([gr[n].float().flatten().cpu() for n in names])

    def cosine(a, b):  # in float64: the gradients have ~1.3e8 elements
        a, b = a.double().flatten(), b.double().flatten()
        return (a @ b / (a.norm() * b.norm())).item()

    def expect(label, counts, want):
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")

    b2 = batch(2)
    loss_cpu, g_cpu = grads_of(ref, sc_cpu, b2)
    reset()
    loss_card, g_card = grads_of(model, sc, b2)
    expect("B=2 gradients", read(), train_launches(acfg, n_text, 1, False, False))
    cos_g = cosine(g_card, g_cpu)
    if not (cos_g >= COS_MIN and abs(loss_card - loss_cpu) <= LOSS_TOL):
        fail(f"B=2 gradients vs CPU fp32: cosine {cos_g}, loss {loss_card} vs "
             f"{loss_cpu}")

    # -- 4c: the opt-in fused LN + projection, at the initial weights -------
    os.environ["VITLENS_ENABLE_FUSED_LNQKV"] = "1"
    try:
        reset()
        loss_opt, g_opt = grads_of(model, sc, b2)
        expect("opt-in B=2 gradients", read(),
               train_launches(acfg, n_text, 1, False, True))
        fb1, ids1 = batch(1)["visual"], b2["text"][:1]
        with torch.no_grad():
            reset()
            emb = tri.encode_visual(model, fb1.cuda(), normalize=True,
                                    compute_dtype=torch.bfloat16)
            n_audio = read()["fused_ln_proj"]
            reset()
            temb = tri.encode_text(model, ids1.cuda(), normalize=True,
                                   compute_dtype=torch.bfloat16)
            n_txt = read()["fused_ln_proj"]
            emb_cpu = tri.encode_visual(ref, fb1, normalize=True)
            temb_cpu = tri.encode_text(ref, ids1, normalize=True)
    finally:
        del os.environ["VITLENS_ENABLE_FUSED_LNQKV"]
    cos_opt = {"audio encode": cosine(emb.cpu(), emb_cpu),
               "text encode": cosine(temb.cpu(), temb_cpu),
               "B=2 gradients": cosine(g_opt, g_cpu)}
    if (n_audio, n_txt) != (acfg.arch.layers, n_text):
        fail(f"opt-in encodes: fused_ln_proj launches audio {n_audio}, text "
             f"{n_txt}, expected {acfg.arch.layers} and {n_text}")
    if min(cos_opt.values()) < COS_MIN or abs(loss_opt - loss_cpu) > LOSS_TOL:
        fail(f"opt-in vs CPU fp32: cosines {cos_opt}, loss {loss_opt} vs {loss_cpu}")
    print(f"[4c opt-in] VITLENS_ENABLE_FUSED_LNQKV=1: fused_ln_proj launches "
          f"{n_audio} per audio encode (B=1), {n_txt} per text encode, "
          f"{train_launches(acfg, n_text, 1, False, True)['fused_ln_proj']} per "
          f"B=2 gradient pass; cosine vs CPU fp32: "
          + " ".join(f"{k} {v:.6f}" for k, v in cos_opt.items())
          + f"; loss {loss_opt:.5f} (CPU {loss_cpu:.5f})", flush=True)

    # -- 4b: train steps -----------------------------------------------------
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not mask[n]}
    train0 = {n: p.detach().clone() for n, p in model.named_parameters()
              if mask[n]}
    state, state_cpu = init_train_state(model, tx), init_train_state(ref, tx)
    step_cpu = make_train_step(cfg, tx, mask, sc_cpu)
    state_cpu, m_cpu = step_cpu(state_cpu, b2)
    del ref, state_cpu
    runs = ([("B=2, the CPU's step", b2, 1, False, False)]
            + [("B=8", None, 1, False, False)] * 3
            + [("B=8 accum_freq 4", None, 4, False, False)] * 2
            + [("B=8 remat", None, 1, True, False),
               ("B=8 opt-in", None, 1, False, True)])
    per_step = []
    for label, bt, accum, remat, opt_in in runs:
        step = make_train_step(cfg, tx, mask, replace(sc, accum_freq=accum,
                                                      remat=remat))
        if opt_in:
            os.environ["VITLENS_ENABLE_FUSED_LNQKV"] = "1"
        try:
            reset()
            state, m = step(state, batch(8) if bt is None else bt)
            counts = read()
        finally:
            os.environ.pop("VITLENS_ENABLE_FUSED_LNQKV", None)
        expect(label, counts, train_launches(acfg, n_text, accum, remat, opt_in))
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"{label}: metrics {m}")
        per_step.append((label, m["loss"], counts))
        if bt is b2:
            m_card = m
    d_loss = abs(m_card["loss"] - float(m_cpu["loss"]))
    d_norm = abs(m_card["grad_norm"] / float(m_cpu["grad_norm"]) - 1)
    if d_loss > LOSS_TOL or d_norm > NORM_TOL:
        fail(f"B=2 step vs CPU fp32: card {m_card}, CPU "
             f"{ {k: float(v) for k, v in m_cpu.items()} }")
    moved = [n for n, p in model.named_parameters() if not mask[n]
             and not torch.equal(p, frozen0[n])]
    still = [n for n, p in model.named_parameters() if mask[n]
             and torch.equal(p, train0[n])]
    if moved or still:
        fail(f"frozen parameters that changed {moved[:5]}, trainable ones "
             f"that did not {still[:5]}")
    del frozen0, train0
    print(f"[4b train] vitlensL audio+text, recipe lock_visual + lock_text + "
          f"unlock_cls: {count_trainable(model, mask)} trainable parameters "
          f"in {len(names)} tensors; phases 4b and 4c took "
          f"{time.time() - t0:.1f} s with the CPU fp32 runs; B=2 vs CPU fp32: gradient cosine {cos_g:.6f}, loss "
          f"{loss_card:.5f} vs {loss_cpu:.5f}, step grad_norm "
          f"{m_card['grad_norm']:.5f} vs {float(m_cpu['grad_norm']):.5f}; steps "
          f"(label, loss, launches) {per_step}; frozen parameters "
          f"bit-identical, every trainable one changed", flush=True)
    return model, state, tx, mask, sc, batch


def tri_train_launches(cfg, accum):
    """Launches per kernel variant of one tri or video-distill train step,
    derived from the config: each pass with grad runs the frozen image
    tower (once over every frame of a clip) and the frozen text tower
    through kernel 1's plain variant and the Lens tower, whose Lens trains,
    through the save-preact variant; accum_freq > 1 adds a cached pass of
    the three towers without grad. Attention: the image tower's trunk and
    the Lens tower's trunk and Lens (the text tower's is plain). A point
    cloud's tokenizer launches FPS once a pass, and the point encoder never
    (it is eval-only, as in JAX: training runs the plain mini-PointNet with
    batch statistics)."""
    li, lt = cfg.vision.layers, cfg.text.layers
    lens = tower_launches(cfg.tower)
    la_mlp, la_attn = lens["fused_mlp"], lens["flash_attention"]
    cached = accum if accum > 1 else 0
    return launch_counts(
        fused_mlp=accum * (li + lt) + cached * (li + lt + la_mlp),
        fused_mlp_save_preact=accum * la_mlp,
        flash_attention=(accum + cached) * (li + la_attn),
        fps=accum + cached if cfg.tower.modality == "pc" else 0)


def tri_batch(torch, np, cfg, b, rng, frames=0):
    """A seeded tri batch on the host: token ids, images (``frames`` > 0:
    clips [B, frames, 3, 224, 224], also the Lens tower's input) and the
    Lens tower's input: depth maps, or point clouds [B, npoints, 3] rounded
    through bf16 once (so that an fp32 run on the CPU gives FPS the
    coordinates the card's bf16 run sees)."""
    text = rng.randint(1, 49000, size=(b, 77))
    text[:, 0], text[:, -1] = 49406, 49407
    shape = (b, frames, 3, 224, 224) if frames else (b, 3, 224, 224)
    image = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    if frames:
        visual = image
    elif cfg.tower.modality == "pc":
        visual = torch.from_numpy((rng.randn(b, cfg.tower.point.npoints, 3)
                                   * 0.3).astype(np.float32)).bfloat16().float()
    else:
        visual = torch.from_numpy(
            rng.randn(b, 1, 224, 224).astype(np.float32))  # depth maps
    return {"text": torch.from_numpy(text).long(), "image": image,
            "visual": visual}


def shared_knn_groups(torch, first, second, sites=None):
    """(first(), second(), a note): second() replays, in order, the groups
    that first() selected at each of ``sites`` ((module, name) of a group
    selection; default ops.fps.knn_indices), so that a card-against-CPU
    comparison holds both to the same neighbourhoods, as it holds them to
    the same FPS starts. In bf16 the distances round as JAX's do (the
    product form, |q|^2 + |p|^2 - 2 q.p, in bf16), which picks other
    neighbours than fp32 in most groups; the note gives that share."""
    from vitlens_tpu_torch.ops import fps as F

    sites = sites or [(F, "knn_indices")]
    originals = [getattr(mod, name) for mod, name in sites]
    made = []

    def recorder(fn):
        def record(xyz, query, *args):
            made.append((fn, xyz, query, args, fn(xyz, query, *args)))
            return made[-1][-1]
        return record

    try:
        for (mod, name), fn in zip(sites, originals):
            setattr(mod, name, recorder(fn))
        a = first()
        replay = iter([idx for *_, idx in made])
        for mod, name in sites:
            setattr(mod, name, lambda xyz, *_: next(replay).to(xyz.device))
        b = second()
    finally:
        for (mod, name), fn in zip(sites, originals):
            setattr(mod, name, fn)
    shares = {}
    for fn, xyz, query, args, idx in made:
        exact = fn(xyz.float(), query.float(), *args)
        differ = (exact.sort(-1).values != idx.sort(-1).values).any(-1)
        shares.setdefault((fn.__name__, xyz.dtype), []).append(
            differ.float().mean().item())
    note = "".join(
        f"; {name} groups of {len(v)} call(s) replayed from the card's pass "
        f"({dtype}: {sum(v) / len(v):.3f} of them differ from fp32 distances' "
        f"on the same centers)" for (name, dtype), v in shares.items())
    return a, b, note


def batch_norm_stats(torch, model):
    """{buffer name: fp32 copy on the CPU} of every BatchNorm running mean
    and var of ``model`` (empty where it has none)."""
    return {n: b.detach().float().cpu().clone()
            for n, b in model.named_buffers()
            if n.endswith((".mean", ".var")) and ".bn" in n}


class batch_norm_trace:
    """Within the block, every train-mode BatchNorm call records its
    running mean right after its update: {module: [tensor, ...]}."""

    def __init__(self, torch):
        from vitlens_tpu_torch.adapters.tokenizers import BatchNorm

        self.cls, self.calls = BatchNorm, {}

    def __enter__(self):
        forward, calls = self.cls.forward, self.calls
        self.forward = forward

        def traced(bn, x, train=False):
            y = forward(bn, x, train)
            if train:
                calls.setdefault(bn, []).append(bn.mean.detach().clone())
            return y

        self.cls.forward = traced
        return self.calls

    def __exit__(self, *exc):
        self.cls.forward = self.forward


def check_running_stats(torch, label, model, calls, before, accum):
    """A step's BatchNorms ran in train mode once a pass (accum_freq 1: one
    pass; otherwise accum_freq cached passes, then accum_freq grad passes),
    and each one's running mean after the step is the one its last cached
    pass left: updated accum_freq times, the grad passes' updates dropped.
    Every running mean and var moved."""
    want_calls = 1 if accum == 1 else 2 * accum
    for bn, means in calls.items():
        if len(means) != want_calls:
            fail(f"{label}: a BatchNorm ran {len(means)} times in train mode, "
                 f"expected {want_calls}")
        if not torch.equal(bn.mean, means[accum - 1]):
            fail(f"{label}: a BatchNorm's running mean is not the one its "
                 f"{accum} cached pass(es) left")
        if accum > 1 and torch.equal(bn.mean, means[-1]):
            fail(f"{label}: the grad passes' running-statistic updates stayed")
    now = batch_norm_stats(torch, model)
    still = [k for k in before if torch.equal(now[k], before[k])]
    if 2 * len(calls) != len(before) or still:
        fail(f"{label}: {len(calls)} BatchNorms ran in train mode for "
             f"{len(before)} running tensors; unmoved {still}")


def tri_train_phase(torch, np, counters, totals, tag, modality, flags, sc,
                    runs, frames=0):
    """Phase 4d, 4e or 4p: a tri-shaped recipe on the vitlensL ``modality``
    model at full width and depth (fp32 trainable masters, frozen weights
    in bf16, bf16 compute). The gradients of one B = 2 pass against the
    same pass on the CPU in fp32 (loss, grad_norm, cosine); then ``runs``
    [(label, B, accum_freq)] steps, each with its launches per kernel
    variant against tri_train_launches; every frozen parameter (the whole
    image tower too) bit-identical, every trainable one changed. A point
    cloud's B = 2 passes start FPS at the same given points on both, the
    CPU pass takes the card pass's kNN groups (shared_knn_groups), and
    their BatchNorm running statistics move alike (cosine of the moves);
    its steps draw the starts from a CUDA generator, and each step leaves
    every BatchNorm's running statistics as its cached passes left them
    (accum_freq of them; the grad passes' updates dropped). Returns what
    phase 5 times."""
    from dataclasses import replace

    from vitlens_tpu_torch.factory import create_model, make_trainable_
    from vitlens_tpu_torch.train.freeze import count_trainable, tri_model_mask
    from vitlens_tpu_torch.train.losses import make_loss_fn
    from vitlens_tpu_torch.train.step import (OptimizerConfig, init_train_state,
                                              make_optimizer, make_train_step,
                                              micro_grads)

    t0 = time.time()
    model = create_model("ViT-L-14", modality, seed=SEED, device="cuda",
                         dtype=torch.float32)
    cfg = model.cfg
    mask = tri_model_mask(model, cfg, **flags)
    tx, mask = make_optimizer(model, OptimizerConfig(
        lr=1e-4, warmup=10, total_steps=1000, grad_clip_norm=1.0), mask)
    make_trainable_(model, mask, torch.bfloat16)
    names = [n for n, t in mask.items() if t]
    loss_fn = make_loss_fn(sc.n_tower, sc.contra_loss_type)
    rng = np.random.RandomState(SEED)
    pc = modality == "pc"
    starts2 = torch.tensor([17, 4242], dtype=torch.int32) if pc else None

    def grads_of(m, step_cfg, bt):
        params = {n: p for n, p in m.named_parameters() if mask[n]}
        dev = m.logit_scale.device
        loss, gr = micro_grads(m, {k: v.to(dev) for k, v in bt.items()},
                               step_cfg, params, loss_fn,
                               None if starts2 is None else starts2.to(dev))
        return float(loss), torch.cat([gr[n].float().flatten().cpu()
                                       for n in names]).double()

    b2 = tri_batch(torch, np, cfg, 2, rng, frames)
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    bn0 = batch_norm_stats(torch, model)

    def cpu_pass():
        t = time.time()
        out = grads_of(ref, replace(sc, compute_dtype=torch.float32), b2)
        return out, time.time() - t

    ((loss_card, g_card), counts), ((loss_cpu, g_cpu), t_cpu), knn_line = \
        shared_knn_groups(torch, lambda: run_counted(
            torch, counters, totals, lambda: grads_of(model, sc, b2)), cpu_pass)
    bn_cpu = batch_norm_stats(torch, ref)
    del ref
    if counts != tri_train_launches(cfg, 1):
        fail(f"{tag} B=2 gradients: launches {counts}, expected "
             f"{tri_train_launches(cfg, 1)}")
    cos_g = (g_card @ g_cpu / (g_card.norm() * g_cpu.norm())).item()
    norm_card, norm_cpu = g_card.norm().item(), g_cpu.norm().item()
    if not (cos_g >= COS_MIN and abs(loss_card - loss_cpu) <= LOSS_TOL
            and abs(norm_card / norm_cpu - 1) <= NORM_TOL):
        fail(f"{tag} B=2 gradients vs CPU fp32: cosine {cos_g}, loss "
             f"{loss_card} vs {loss_cpu}, grad_norm {norm_card} vs {norm_cpu}")
    bn_line = ""
    if bn0:  # the running statistics' moves, card against CPU
        bn_card = batch_norm_stats(torch, model)
        moves = {k: cos_min(torch, (bn_card[k] - bn0[k])[None],
                            (bn_cpu[k] - bn0[k])[None]) for k in bn0}
        if min(moves.values()) < COS_MIN:
            fail(f"{tag} B=2: running statistics moved unlike the CPU's: "
                 f"cosines {moves}")
        bn_line = (f"; running statistics after the B=2 pass, cosine of "
                   f"their moves vs CPU fp32: " + ", ".join(
                       f"{k} {v:.6f}" for k, v in moves.items()))

    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not mask[n]}
    train0 = {n: p.detach().clone() for n, p in model.named_parameters()
              if mask[n]}
    state = init_train_state(model, tx)
    gen = torch.Generator(device="cuda").manual_seed(SEED) if pc else None
    per_step = []
    for label, b, accum in runs:
        step = make_train_step(cfg, tx, mask, replace(sc, accum_freq=accum))
        bt = tri_batch(torch, np, cfg, b, rng, frames)
        before = batch_norm_stats(torch, model)
        with batch_norm_trace(torch) as trace:
            (state, m), counts = run_counted(
                torch, counters, totals, lambda: step(state, bt, fps_generator=gen))
        if counts != tri_train_launches(cfg, accum):
            fail(f"{tag} {label}: launches {counts}, expected "
                 f"{tri_train_launches(cfg, accum)}")
        check_running_stats(torch, f"{tag} {label}", model, trace, before, accum)
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"{tag} {label}: metrics {m}")
        per_step.append((label, round(m["loss"], 5), counts["fused_mlp"],
                         counts["fused_mlp_save_preact"],
                         counts["flash_attention"], counts["fps"],
                         counts["point_encoder"]))
    moved = [n for n, p in model.named_parameters() if not mask[n]
             and not torch.equal(p, frozen0[n])]
    still = [n for n, p in model.named_parameters() if mask[n]
             and torch.equal(p, train0[n])]
    if moved or still:
        fail(f"{tag}: frozen parameters that changed {moved[:5]}, trainable "
             f"ones that did not {still[:5]}")
    n_image = sum(1 for n in frozen0 if n.startswith("image."))
    del frozen0, train0
    print(f"[{tag}] vitlensL {modality} tri model, {flags}, {sc.n_tower} "
          f"towers, video_distill {sc.video_distill}, loss "
          f"{sc.contra_loss_type}: {count_trainable(model, mask)} trainable "
          f"parameters in {len(names)} tensors; B=2 vs CPU fp32: gradient "
          f"cosine {cos_g:.6f}, loss {loss_card:.5f} vs {loss_cpu:.5f}, "
          f"grad_norm {norm_card:.5f} vs {norm_cpu:.5f} (the CPU pass took "
          f"{t_cpu:.1f} s){knn_line}{bn_line}; steps (label, loss, launches plain, "
          f"save-preact, attention, FPS, point encoder) {per_step}; frozen "
          f"parameters bit-identical ({n_image} tensors of the image tower "
          f"among them), every trainable one changed"
          + (f"; each step's BatchNorm running statistics those of its "
             f"accum_freq cached passes ({len(bn0)} tensors)" if bn0 else "")
          + f"; phase took {time.time() - t0:.1f} s", flush=True)
    return model, state, tx, mask, sc


def profile_encode(torch, card, label, encode):
    """One call under torch.profiler: the top kernels by device time and the
    device's busy and idle share. Returns (the kernels' profiler rows,
    busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    for e in kernels[:15]:  # the top kernels by device time
        t = e.self_device_time_total / 1e3
        print(f"    {t:9.3f} ms {100 * t / busy_ms:5.1f}% {e.count:5d}x "
              f"{e.key[:110]}")
    print(f"[5 profile] {card} | {label} under the profiler: device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.2f} ms wall (idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f})", flush=True)
    return kernels, busy_ms


def encode_rate(torch, card, label, encode, samples, rows_note="", dim=768):
    encode()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        emb = encode()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    if tuple(emb.shape) != (samples, dim) or not torch.isfinite(emb).all():
        fail(f"{label}: bad output")
    best = min(runs)
    print(f"[5 timing] {card} | {label}: {samples / best:.2f} samples/s"
          f"{rows_note}, best of {len(runs)}: {best * 1e3:.2f} ms, all ms "
          f"{[round(r * 1e3, 2) for r in runs]}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return samples / best


def encode_latency(torch, card, label, encode, runs=5):
    """Host-timed latency of one request: the best of ``runs`` calls, each
    ending in torch.cuda.synchronize(). Returns ms."""
    encode()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[5 timing] {card} | {label}: latency best of {runs} "
          f"{min(times):.2f} ms, all ms {[round(t, 2) for t in times]}", flush=True)
    return min(times)


def train_rate(torch, card, label, step, samples, runs=3):
    step()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"[5 timing] {card} | {label}: {samples / best:.2f} samples/s, best "
          f"of {runs}: {best * 1e3:.2f} ms, all ms "
          f"{[round(t * 1e3, 2) for t in times]}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({resident / 1e9:.2f} "
          f"GB resident between steps)", flush=True)
    return samples / best


def tri_timings(torch, np, card, runs):
    """Phase 5's train-step rates: for each (trained phase, frames, batch
    sizes) of ``runs``, the step at the first size that fits, with its peak
    memory and one step under the profiler; a point-cloud step draws its
    FPS starts from a CUDA generator. Returns {name: (B, rate)}."""
    from vitlens_tpu_torch.train.step import make_train_step

    rng = np.random.RandomState(SEED)
    rates = {}
    for (model, state, tx, mask, sc), frames, sizes in runs:
        modality = model.cfg.tower.modality
        name = ("video distill" if sc.video_distill else f"{modality} tri")
        step = make_train_step(model.cfg, tx, mask, sc)
        gen = (torch.Generator(device="cuda").manual_seed(SEED)
               if modality == "pc" else None)
        for b in sizes:
            bt = {k: v.cuda() for k, v in
                  tri_batch(torch, np, model.cfg, b, rng, frames).items()}
            try:
                rate = train_rate(torch, card, f"{name} train step B{b} bf16 "
                                  f"(frozen image tower in bf16"
                                  + (f", {b * frames} frames a step" if frames
                                     else "") + ")",
                                  lambda: step(state, bt, fps_generator=gen), b)
            except torch.cuda.OutOfMemoryError:
                del bt
                torch.cuda.empty_cache()
                print(f"[5 timing] {card} | {name} train step B{b}: out of "
                      "device memory", flush=True)
                continue
            profile_encode(torch, card, f"B{b} {name} train step",
                           lambda: step(state, bt, fps_generator=gen))
            rates[name] = (b, rate)
            del bt
            break
        else:
            fail(f"{name} train step: no batch size fits")
        torch.cuda.empty_cache()
    return rates


def ball_query_bound(b, s, n, k):
    """Per (query, point) pair: the distance in the matmul form (3 products
    and 3 adds of the dot, 2 adds of the norms), the radius compare and the
    candidate select, then at least one compare of the k-smallest
    selection, on the fp32 cores; bytes: the bf16 points and queries read
    once, the int32 indices written once."""
    pairs = b * s * n
    return bound(11 * pairs, 2 * 3 * (b * n + b * s) + 4 * b * s * k, PEAK_FP32)


def vitlensG_timings(torch, card, model, b=16):
    """Phase 5's vitlensG pc encode: B16 clouds of 10000 x 6 (arrays given)
    with its peak memory and a profile; then the ball query at that
    encode's shape ([16, 512, 10000], 64 a ball, bf16 points) beside its
    bound. Returns the encode rate."""
    from vitlens_tpu_torch.ops.fps import ball_query, fps

    g = torch.Generator(device="cuda").manual_seed(SEED)
    pt = model.towers["pc"].cfg.point
    pc = torch.cat([torch.randn(b, pt.npoints, 3, generator=g, device="cuda") * 0.4,
                    torch.rand(b, pt.npoints, 3, generator=g, device="cuda")], -1)

    def encode():
        return model.encode({"pc": pc}, preprocessed=True)["pc"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rate = encode_rate(torch, card, f"vitlensG pc encode B{b} x {pt.npoints} "
                       f"points x 6 bf16 (PNSA, bigG trunk, 32 of 48 blocks)",
                       encode, b, dim=1280)
    profile_encode(torch, card, f"B{b} vitlensG pc encode", encode)
    xyz = pc[..., :3].bfloat16().contiguous()
    centers = fps(xyz, pt.num_group)
    ms = cuda_ms(lambda: ball_query(xyz, centers, pt.radius, pt.group_size))
    bd, by = ball_query_bound(b, pt.num_group, pt.npoints, pt.group_size)
    print(f"[5 timing] {card} | ball query (plain PyTorch: the distance "
          f"product, torch.topk over int32 candidates) [{b}, {pt.num_group}, "
          f"{pt.npoints}] k {pt.group_size} bf16 points: {ms:.4f} ms, bound "
          f"{bd:.4f} ms ({by})", flush=True)
    return rate


def check_attention_edges(torch, g, err, checks):
    """Attention at the edges of its tiling: every NQ, NK in {1, 7, 77, 257,
    600} and NK of 833 and 2048 keys (more chunks than the ring holds),
    against the plain version; and the trunk's packed-qkv views and the
    Lens's q / to_kv views bit-equal to the same call on contiguous
    copies."""
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)

    worst = 0.0
    for b, h, nq, nk in (*((2, 3, nq, nk) for nq in (1, 7, 77, 257, 600)
                           for nk in (1, 7, 77, 257, 600)),
                         (2, 2, 257, 833), (3, 1, 256, 2048)):
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v)
        e = rel_err(got, want)
        worst = max(worst, e)
        err["flash_attention"] = max(err["flash_attention"], abs_err(got, want))
        if not (torch.isfinite(got).all() and e <= ATTN_TOL):
            fail(f"flash_attention {b}x{h}x{nq}x{nk}: rel err {e} > {ATTN_TOL}")
    checks.append(f"attn-edges(NQ,NK in 1..600, NK 833, 2048)<={worst:.2e}")
    for label, b, nq, nk, h, packed in (("packed-qkv", 4, 257, 257, 16, True),
                                        ("packed-qkv", 2, 77, 77, 12, True),
                                        ("lens-cross", 4, 256, 600, 1, False),
                                        ("lens-self", 2, 256, 256, 16, False)):
        if packed:
            qkv = torch.randn(b, nq, 3 * h * 64, generator=g, device="cuda").bfloat16()
            q, k, v = qkv.view(b, nq, 3, h, 64).permute(2, 0, 3, 1, 4)
        else:
            q = torch.randn(b, nq, h * 64, generator=g, device="cuda").bfloat16()
            kv = torch.randn(b, nk, 2 * h * 64, generator=g, device="cuda").bfloat16()
            q = q.view(b, nq, h, 64).transpose(1, 2)
            k, v = kv.view(b, nk, 2, h, 64).permute(2, 0, 3, 1, 4)
        got = flash_attention(q, k, v)
        want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"flash_attention on {label} views B{b} NQ{nq} NK{nk} H{h}: "
                 "differs from the call on contiguous copies")
        checks.append(f"attn-{label}-views{b}x{h}x{nq}x{nk}=bit-equal")


# the trunks' head dims besides 64, and the CoCa L-14 pooler's 96
OTHER_HEAD_DIMS = (32, 80, 88, 96, 104, 112, 128)


def check_head_dims(torch, g, err, checks):
    """Attention at head dims other than 64 (the trunks of ViT-H-14,
    ViT-g-14, ViT-bigG-14 and ViT-e-14 have 80, 88, 104 and 112): every NQ,
    NK in {1, 77, 257, 600} on contiguous tensors and on the packed qkv
    projection's views, against the plain version (bf16, <= ATTN_TOL)."""
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)

    for d in OTHER_HEAD_DIMS:
        worst = 0.0
        for nq in (1, 77, 257, 600):
            for nk in (1, 77, 257, 600):
                cases = [("", qkv_inputs(torch, g, 2, 3, nq, nk, d))]
                if nq == nk:  # the trunk's packed qkv, read in place
                    qkv = torch.randn(2, nq, 3 * 3 * d, generator=g,
                                      device="cuda").bfloat16()
                    cases.append((" packed-qkv views", tuple(
                        qkv.view(2, nq, 3, 3, d).permute(2, 0, 3, 1, 4))))
                for kind, args in cases:
                    got = flash_attention(*args)
                    torch.cuda.synchronize()
                    want = attention_reference(*args)
                    e = rel_err(got, want)
                    worst = max(worst, e)
                    err["flash_attention"] = max(err["flash_attention"],
                                                 abs_err(got, want))
                    if not (torch.isfinite(got).all() and e <= ATTN_TOL):
                        fail(f"flash_attention D={d} NQ={nq} NK={nk}{kind}: "
                             f"rel err {e} > {ATTN_TOL}")
        checks.append(f"attn-D{d}(NQ,NK in 1..600, packed views)<={worst:.2e}")


def check_int8_epilogues(torch, g, err, checks):
    """The quantise kernel bit-equal to its plain version at the quantized
    encode's shapes (its inputs' K: 1024 for qkv, out and fc, 4096 for proj)
    and at a ragged M, bf16 and fp32 input; the DEQUANT epilogue bit-equal
    to the plain dequantise of the same int32 product, with and without bias
    and in bf16 and fp32; and quant.int8_matmul on the card (quantise ->
    DEQUANT) bit-equal to its plain version end to end."""
    from vitlens_tpu_torch import quant
    from vitlens_tpu_torch.ops.int8_matmul import (
        dequant_reference, int8_matmul_dequant, int8_matmul_reference,
        int8_quantize, int8_quantize_reference)

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    m = 257 * B * 3
    # why the plain quantise divides by a tensor: PyTorch's CUDA division by
    # a Python scalar multiplies by the reciprocal instead
    a = torch.rand(1 << 16, generator=g, device="cuda") * 100
    n_recip = ((a / 127.0) != (a / a.new_tensor(127.0))).sum().item()
    checks.append(f"cuda-x/127.0-vs-IEEE-x/127:{n_recip}-of-65536-differ")
    err["int8_quantize"] = err["int8_matmul_dequant"] = 0.0
    for m_, k, dt in ((m, 1024, torch.bfloat16), (m, 4096, torch.bfloat16),
                      (1001, 3072, torch.bfloat16), (1001, 1024, torch.float32)):
        x = quant_rows(torch, g, m_, k, dt)
        xi, xs = int8_quantize(x)
        torch.cuda.synchronize()
        want_i, want_s = int8_quantize_reference(x)
        n_diff = (xi != want_i).sum().item() + (bits(xs) != bits(want_s)).sum().item()
        err["int8_quantize"] = max(err["int8_quantize"],
                                   (xs - want_s).abs().max().item())
        checks.append(f"quantize {m_}x{k}/{str(dt)[6:]}:{n_diff}-differ")
        if n_diff:
            fail(f"int8_quantize {m_}x{k} {dt}: {n_diff} of xi and xs differ "
                 "from the plain version")
        del x, xi, xs, want_i, want_s
    for m_, k, n in ((m, 1024, 4096), (m, 4096, 1024), (1001, 1024, 3072)):
        a, b, b_t = int8_inputs(torch, g, m_, k, n)
        acc = int8_matmul_reference(a, b)
        xs = torch.rand(m_, 1, generator=g, device="cuda") * 0.02 + 1e-4
        ws = torch.rand(1, n, generator=g, device="cuda") * 0.01 + 1e-5
        bias = torch.randn(n, generator=g, device="cuda")
        for bb, dt in ((bias, torch.bfloat16), (None, torch.bfloat16),
                       (bias, torch.float32)):
            got = int8_matmul_dequant(a, b, xs, ws, bb, dt, b_t)
            torch.cuda.synchronize()
            want = dequant_reference(acc, xs, ws, bb, dt)
            n_diff = (bits(got) != bits(want)).sum().item()
            err["int8_matmul_dequant"] = max(err["int8_matmul_dequant"],
                                             abs_err(got, want))
            checks.append(f"dequant {m_}x{k}x{n}/{'bias' if bb is not None else 'no-bias'}"
                          f"/{str(dt)[6:]}:{n_diff}-differ")
            if n_diff:
                fail(f"int8_matmul_dequant {m_}x{k}x{n} {dt}: {n_diff} elements "
                     "differ from the plain dequantise of the same product")
        del a, b, b_t, acc, got, want
    for m_, k, n in ((m, 1024, 3072), (77 * 8, 768, 2304)):  # end to end
        x = quant_rows(torch, g, m_, k, torch.bfloat16)
        w_q, w_s = quant.quantize_weight(torch.randn(k, n, generator=g, device="cuda") * 0.05)
        bias = torch.randn(n, generator=g, device="cuda")
        got = quant.int8_matmul(x, w_q, w_s, bias, w_q.t().contiguous())
        torch.cuda.synchronize()
        n_diff = (bits(got) != bits(quant.int8_matmul_reference(x, w_q, w_s, bias))).sum().item()
        checks.append(f"quant.int8_matmul {m_}x{k}x{n}:{n_diff}-differ")
        if n_diff:
            fail(f"quant.int8_matmul {m_}x{k}x{n} on the card: {n_diff} elements "
                 "differ from its plain version")
        del x, got


def check_new_kernels(torch, g, err, checks):
    """Phase 3, continued: the int8 product, the row gather, the chained
    fused MLPs and the fused LN + projection at the LN + qkv prototype's
    shape, each against its plain version on the card."""
    from vitlens_tpu_torch.ops.fused_ln_proj import (fused_ln_proj,
                                                     ln_proj_reference)
    from vitlens_tpu_torch.ops.fused_mlp_chain import (
        fused_attnout_mlp, fused_mlp_chain_reference, fused_mlp_chunked)
    from vitlens_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                   int8_matmul_reference)
    from vitlens_tpu_torch.ops.row_gather import row_gather, row_gather_reference

    err["int8_matmul"] = 0.0
    for m, k, n in ((4096, 4096, 4096), (771 * 64, 1024, 3072), (1001, 4096, 1024)):
        a, b, b_t = int8_inputs(torch, g, m, k, n)
        got = int8_matmul(a, b, b_t)
        torch.cuda.synchronize()
        want = int8_matmul_reference(a, b)
        n_diff = (got != want).sum().item()
        err["int8_matmul"] = max(err["int8_matmul"],
                                 (got.long() - want.long()).abs().max().item())
        checks.append(f"int8 {m}x{k}x{n}:{n_diff}-differ")
        if n_diff:
            fail(f"int8_matmul {m}x{k}x{n}: {n_diff} elements differ from the "
                 "plain version (the product is exact)")
        del a, b, b_t, got, want
    v, d, j = 49408, 512, 9856
    table = torch.randn(v, d, generator=g, device="cuda").bfloat16()
    ids = torch.randint(0, v, (j,), generator=g, device="cuda", dtype=torch.int32)
    ids[:4] = torch.tensor([0, v - 1, 7, 7], dtype=torch.int32)
    got = row_gather(table, ids)
    torch.cuda.synchronize()
    want = row_gather_reference(table, ids)
    n_diff = (got.view(torch.int16) != want.view(torch.int16)).sum().item()
    err["row_gather"] = abs_err(got, want)
    checks.append(f"gather {v}x{d} J{j}:{n_diff}-differ")
    if n_diff:
        fail(f"row_gather: {n_diff} elements differ bitwise from table[ids]")
    err["fused_mlp_chunked"] = err["fused_attnout_mlp"] = 0.0
    for m, d, h in ((16448, 1024, 4096), (1001, 1024, 4096), (777, 256, 1024),
                    (300, 128, 512)):
        x, *mlp = mlp_inputs(torch, g, m, d, h)
        proj = outproj_inputs(torch, g, m, d)
        for act in ("gelu_tanh", "gelu"):
            for name, got, want in (
                    ("fused_mlp_chunked", fused_mlp_chunked(x, *mlp, act=act),
                     fused_mlp_chain_reference(x, *mlp, act=act)),
                    ("fused_attnout_mlp",
                     fused_attnout_mlp(x, *proj, *mlp, act=act),
                     fused_mlp_chain_reference(x, *mlp, act=act, outproj=proj))):
                torch.cuda.synchronize()
                e = rel_err(got, want)
                err[name] = max(err[name], abs_err(got, want))
                checks.append(f"{name} M{m}xD{d}/{act}={e:.2e}")
                if not (torch.isfinite(got).all() and e <= CHAIN_TOL):
                    fail(f"{name} M={m} D={d} {act}: rel err {e} > {CHAIN_TOL}")
        del x, mlp, proj
    a = ln_proj_inputs(torch, g, 16448, 1024, 3072)
    got = fused_ln_proj(*a)
    torch.cuda.synchronize()
    want = ln_proj_reference(*a)
    e = rel_err(got, want)
    err["fused_ln_qkv"] = abs_err(got, want)
    checks.append(f"ln_qkv 16448x1024x3072={e:.2e}")
    if not (torch.isfinite(got).all() and e <= LNP_TOL):
        fail(f"fused_ln_proj at the LN + qkv prototype's shape: rel err {e} > "
             f"{LNP_TOL}")


def run_counted(torch, counters, totals, fn):
    """fn() with every launch count set to 0 just before and read just
    after; the counts are added to the main-path totals."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {name: c.launches for name, c in counters.items()}
    for name, n in counts.items():
        totals[name] += n
    return out, counts


def cos_min(torch, a, b):
    return torch.nn.functional.cosine_similarity(
        a.float().cpu(), b.float().cpu(), dim=-1).min().item()


FP32_COS_MIN = 0.999  # fp32 on the card against fp32 on the CPU


def transformer_lens_phase(torch, counters, totals):
    """Phase 4t: a vitlensL depth tower whose Lens is the transformer Lens
    (2 trunk-width blocks; no released config uses it) at full width and
    depth, random weights from a seeded generator: a B = 2 bf16 encode on
    the card with the launches derived from the config (26 fused MLP + 26
    attention) and cosine >= 0.99 against the same tower in fp32 on the
    CPU."""
    from vitlens_tpu_torch.config import make_model_config
    from vitlens_tpu_torch.factory import cast_matmul_weights_, make_generator
    from vitlens_tpu_torch.models.vit import VisionTower

    t0 = time.time()
    cfg = make_model_config("ViT-L-14", "depth").tower
    cfg = dataclasses.replace(cfg, perceiver=dataclasses.replace(
        cfg.perceiver, as_identity=False, as_transformer=True, depth=2))
    tower = VisionTower(cfg, device="cuda")
    tower.init_(make_generator(SEED, "cuda"))
    ref = copy.deepcopy(tower).to(device="cpu")
    cast_matmul_weights_(tower, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(2, 1, 224, 224, generator=g, device="cuda")
    with torch.inference_mode():
        emb, counts = run_counted(torch, counters, totals,
                                  lambda: tower(x, torch.bfloat16))
        want = ref(x.cpu())
    if counts != tower_launches(cfg) or counts["fused_mlp"] != 26:
        fail(f"4t transformer Lens: launches {counts}, expected "
             f"{tower_launches(cfg)}")
    cos = cos_min(torch, emb, want)
    if cos < COS_MIN or not torch.isfinite(emb).all():
        fail(f"4t transformer Lens: cosine vs CPU fp32 {cos} < {COS_MIN}")
    print(f"[4t transformer Lens] vitlensL depth tower with a 2-block "
          f"transformer Lens, B=2 bf16: launches (fused MLP, attention) "
          f"{counts['fused_mlp']}, {counts['flash_attention']}; cosine vs CPU "
          f"fp32 {cos:.6f}; phase took {time.time() - t0:.1f} s", flush=True)


def fp32_phase(torch, counters, totals, fb2, clouds2, captions2):
    """Phase 4f: the default ViTLens (compute fp32, as in JAX) encodes B = 2
    of each modality on the card through the plain paths (the kernels take
    bf16): no fused MLP, attention or point-encoder launch, the FPS launch as
    in bf16; against the same model in fp32 on the CPU."""
    from vitlens_tpu_torch.api import ViTLens

    t0 = time.time()
    model = ViTLens("vitlensL", ("audio", "pc", "text"), device="cuda", seed=SEED)
    if model.compute_dtype != torch.float32:
        fail(f"ViTLens's default compute dtype is {model.compute_dtype}, not fp32")
    ref = copy.deepcopy(model).to("cpu")
    want = {"audio": launch_counts(), "pc": launch_counts(fps=1),
            "text": launch_counts()}
    cos, per_call = {}, []
    for path, data, pre in (("audio", fb2, True), ("pc", clouds2, True),
                            ("text", captions2, False)):
        emb, counts = run_counted(torch, counters, totals,
                                  lambda: model.encode({path: data}, preprocessed=pre)[path])
        if counts != want[path]:
            fail(f"fp32 {path} B=2: launches {counts}, expected {want[path]}")
        if tuple(emb.shape) != (2, 768) or not torch.isfinite(emb).all():
            fail(f"fp32 {path} B=2: shape {tuple(emb.shape)} or non-finite values")
        cpu_data = data.cpu() if isinstance(data, torch.Tensor) else data
        cos[path] = cos_min(torch, emb, ref.encode({path: cpu_data},
                                                   preprocessed=pre)[path])
        per_call.append((path, counts["fps"]))
    # cuDNN runs the audio adapter's fp32 convolution in TF32 by default
    # (fp32 products outside it stay fp32): the same encode without it.
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cos_no_tf32 = cos_min(torch, model.encode({"audio": fb2}, preprocessed=True)["audio"],
                              ref.encode({"audio": fb2.cpu()}, preprocessed=True)["audio"])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del model, ref
    if min(cos.values()) < FP32_COS_MIN:
        fail(f"fp32 card vs CPU: min cosine {cos} < {FP32_COS_MIN}")
    print(f"[4f fp32 default] ViTLens('vitlensL', ('audio', 'pc', 'text')) "
          f"(compute fp32) on the card, B=2 each: no fused MLP, attention or "
          f"point-encoder launch, FPS launches per request {per_call}; min "
          f"cosine vs CPU fp32: audio {cos['audio']:.7f} (cudnn.allow_tf32="
          f"{tf32}; {cos_no_tf32:.7f} with it off), pc {cos['pc']:.7f}; "
          f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}; phase took "
          f"{time.time() - t0:.1f} s with the CPU run", flush=True)
    print(f"[4f fp32 default] text encode B=2 (ResBlock plain MLP, masked "
          f"plain_attention): min cosine vs CPU fp32 {cos['text']:.7f}, no "
          f"kernel launch", flush=True)


HD_DEPTH = 4  # trunk blocks kept in the head-dim phase (the CPU run stays short)


def head_dim_phase(torch, counters, totals, fb1):
    """Phase 4h: bf16 B = 1 audio encodes at full width whose trunks have
    head dims other than 64, on the card against the CPU in fp32, with
    launch counts derived from the config: ViTLens("vitlensG", ("audio",))
    (ViT-bigG-14, head dim 104) and a ViT-H-14 audio tower (head dim 80),
    each trunk cut to HD_DEPTH blocks."""
    from dataclasses import replace

    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.config import make_model_config
    from vitlens_tpu_torch.factory import cast_matmul_weights_, make_generator
    from vitlens_tpu_torch.models.vit import VisionTower

    t0 = time.time()
    big = ViTLens("vitlensG", ("audio",), device="cuda",
                  compute_dtype=torch.bfloat16, seed=SEED)
    big.towers["audio"].trunk.blocks = big.towers["audio"].trunk.blocks[:HD_DEPTH]
    torch.cuda.empty_cache()
    cfg = make_model_config("ViT-H-14", "audio").tower
    h14 = VisionTower(replace(cfg, arch=replace(cfg.arch, layers=HD_DEPTH)),
                      device="cuda")
    h14.init_(make_generator(SEED, "cuda"))
    cast_matmul_weights_(h14, torch.bfloat16)
    clips = fb1.reshape((-1,) + tuple(fb1.shape[2:]))  # [3, T, F]

    def h14_encode(tower, x, dtype):
        f = tower(x, dtype).float().mean(dim=0, keepdim=True)
        return f / f.norm(dim=-1, keepdim=True)

    lines = []
    for label, net, encode, ref_encode in (
            ("vitlensG audio (ViT-bigG-14, head dim 104)", big,
             lambda m: m.encode({"audio": fb1}, preprocessed=True)["audio"],
             lambda m: m.encode({"audio": fb1.cpu()}, preprocessed=True)["audio"]),
            ("ViT-H-14 audio tower (head dim 80)", h14,
             lambda m: h14_encode(m, clips, torch.bfloat16),
             lambda m: h14_encode(m, clips.cpu(), torch.float32))):
        tcfg = net.towers["audio"].cfg if net is big else net.cfg
        heads = tcfg.arch.width // tcfg.arch.heads
        want = launch_counts(
            fused_mlp=HD_DEPTH,
            flash_attention=HD_DEPTH + tcfg.perceiver.depth * (
                1 + tcfg.perceiver.self_per_cross_attn))
        emb, counts = run_counted(torch, counters, totals, lambda: encode(net))
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")
        if tuple(emb.shape) != (1, tcfg.embed_dim) or not torch.isfinite(emb).all():
            fail(f"{label}: shape {tuple(emb.shape)} or non-finite values")
        ref = copy.deepcopy(net).to(device="cpu", dtype=torch.float32)
        if net is big:
            ref.compute_dtype = torch.float32
        cos = cos_min(torch, emb, ref_encode(ref))
        del ref
        if cos < COS_MIN:
            fail(f"{label}: cosine vs CPU fp32 {cos} < {COS_MIN}")
        lines.append(f"{label}, width {tcfg.arch.width}, head dim {heads}: "
                     f"launches (fused MLP, attention) {counts['fused_mlp']}, "
                     f"{counts['flash_attention']}; cosine vs CPU fp32 {cos:.6f}")
    del big, h14
    torch.cuda.empty_cache()
    print(f"[4h head dims] bf16 B=1 x 3 clips audio encodes at full width, each "
          f"trunk cut to {HD_DEPTH} blocks (the CPU fp32 run stays short): "
          + "; ".join(lines) + f"; phase took {time.time() - t0:.1f} s", flush=True)


def quant_phase(torch, model, counters, totals, fb1, fb64, captions, want):
    """Phase 4q: the audio tower quantized to int8 on the card and driven
    through ViTLens.encode. Returns the quantized model."""
    from vitlens_tpu_torch.quant import (is_quantized, quantize_model,
                                         quantize_weight)

    t0 = time.time()
    qmodel = quantize_model(model, towers=("towers.audio",))
    tower, source = qmodel.towers["audio"], model.towers["audio"]
    if (not is_quantized(tower) or is_quantized(source)
            or is_quantized(qmodel.towers["text"])
            or tower.trunk.blocks[0].mlp.fc.w is not None):
        fail("quantize_model: the copy's audio trunk must be quantized, "
             "nothing else")
    last = len(source.trunk.blocks) - 1
    for i in (0, last):
        fb, qb = source.trunk.blocks[i], tower.trunk.blocks[i]
        for name, w, q, q_t, s_card in (
                ("qkv", fb.attn.qkv_w, qb.attn.qkv_w_q, qb.attn.qkv_w_qt,
                 qb.attn.qkv_w_s),
                ("out", fb.attn.out_w, qb.attn.out_w_q, qb.attn.out_w_qt,
                 qb.attn.out_w_s),
                ("fc", fb.mlp.fc.w, qb.mlp.fc.w_q, qb.mlp.fc.w_qt, qb.mlp.fc.w_s),
                ("proj", fb.mlp.proj.w, qb.mlp.proj.w_q, qb.mlp.proj.w_qt,
                 qb.mlp.proj.w_s)):
            q_cpu, s_cpu = quantize_weight(w.cpu())
            if not (torch.equal(q.cpu(), q_cpu) and torch.equal(q_t.cpu(), q_cpu.t())
                    and torch.equal(s_card.cpu(), s_cpu)):
                fail(f"block {i} {name}: w_q or w_s made on the card differs "
                     "from the one made on the CPU")
    embs, per_call = {}, []
    for label, b, key, inputs in (("audio B=1", 1, "audio", {"audio": fb1}),
                                  (f"audio B={B}", B, "audio", {"audio": fb64}),
                                  ("text", len(captions), "text",
                                   {"text": captions})):
        emb, counts = run_counted(
            torch, counters, totals,
            lambda: qmodel.encode(inputs, preprocessed=key == "audio")[key])
        if counts != want[key]:
            fail(f"quantized {label}: launches {counts}, expected {want[key]}")
        norm_err = (emb.float().norm(dim=-1) - 1).abs().max().item()
        if (tuple(emb.shape) != (b, 768) or not torch.isfinite(emb).all()
                or norm_err > 1e-3):
            fail(f"quantized {label}: shape {tuple(emb.shape)}, norms off 1 by "
                 f"{norm_err}, or non-finite values")
        embs[label] = emb.float()
        per_call.append((label, counts["int8_matmul_dequant"],
                         counts["int8_quantize"], counts["flash_attention"],
                         counts["fused_mlp"]))
    # the text tower quantized too: D = 768 products on a ragged M = B * 77
    both = quantize_model(qmodel, towers=("towers.text",))
    temb, counts = run_counted(torch, counters, totals,
                               lambda: both.encode({"text": captions})["text"].float())
    if counts != want["text_int8"]:
        fail(f"quantized text: launches {counts}, expected {want['text_int8']}")
    per_call.append(("text, int8 tower", counts["int8_matmul_dequant"],
                     counts["int8_quantize"], counts["flash_attention"],
                     counts["fused_mlp"]))
    del both
    # what the int8 encodes are held against (these launches are not counted)
    floats = {label: model.encode({"audio": fb}, preprocessed=True)["audio"].float()
              for label, fb in (("audio B=1", fb1), (f"audio B={B}", fb64))}
    qref = copy.deepcopy(qmodel).to(device="cpu", dtype=torch.float32)
    qref.compute_dtype = torch.float32
    cpu1 = qref.encode({"audio": fb1.cpu()}, preprocessed=True)["audio"]
    del qref

    cos = {"B=1 int8 card vs quantized fp32 CPU": cos_min(torch, embs["audio B=1"], cpu1),
           "B=1 int8 vs float bf16, card": cos_min(torch, embs["audio B=1"],
                                                   floats["audio B=1"]),
           f"B={B} int8 vs float bf16, card": cos_min(torch, embs[f"audio B={B}"],
                                                      floats[f"audio B={B}"]),
           "text int8 vs float bf16, card": cos_min(torch, temb, embs["text"])}
    if min(cos.values()) < COS_MIN:
        fail(f"quantized audio encode: min cosine {cos} < {COS_MIN}")
    print(f"[4q quantized] vitlensL audio trunk quantized to int8 on the card "
          f"(w_q, its transposed copy and w_s equal to the CPU's for blocks 0 "
          f"and {last}); requests (label, DEQUANT products, quantise, "
          f"attention, fused MLP launches) {per_call}; min cosine: "
          + "; ".join(f"{k} {v:.6f}" for k, v in cos.items())
          + f"; phase took {time.time() - t0:.1f} s with the CPU fp32 run",
          flush=True)
    return qmodel


SCRIPT_RUNS = (  # (entry point, arguments, the counter its kernel adds to)
    ("fused_mlp_chunked", ["--iters", "5"], "fused_mlp_chunked"),
    ("fused_ln_qkv", ["--iters", "5"], "fused_ln_proj"),
    ("fused_attnout_mlp", ["--iters", "5"], "fused_attnout_mlp"),
    ("bench_int8_native", ["--iters", "10"], "int8_matmul"),
    ("bench_dma_gather", ["--iters", "50"], "row_gather"),
    ("bench_int8_encode", ["--iters", "3"], "int8_matmul_dequant"))


def scripts_phase(torch, counters, totals):
    """Phase 4s: the bench entry points, in this process, each with the
    launches of its kernel. Returns {entry point: launches}."""
    import importlib

    by_script = {}
    for name, argv, kernel in SCRIPT_RUNS:
        module = importlib.import_module(f"vitlens_tpu_torch.scripts.{name}")
        print(f"[4s scripts] python -m vitlens_tpu_torch.scripts.{name} "
              f"{' '.join(argv)}", flush=True)
        rc, counts = run_counted(torch, counters, totals, lambda: module.main(argv))
        if rc != 0 or counts[kernel] == 0:
            fail(f"scripts.{name}: exit code {rc}, {kernel} launches "
                 f"{counts[kernel]}")
        by_script[name] = counts[kernel]
    print(f"[4s scripts] every entry point exited 0; launches of its kernel: "
          f"{by_script}", flush=True)
    return by_script


def time_new_kernels(torch, g, timings):
    """Phase 5, continued: the int8 product's two epilogues and the quantise
    kernel, the row gather (its device time, and the wrapper's time back to
    back and its host time a call, beside index_select's) and the chained
    fused MLPs at their shapes, beside plain, library and bound."""
    from vitlens_tpu_torch.ops.fused_mlp import fused_mlp
    from vitlens_tpu_torch.ops.fused_mlp_chain import (
        fused_attnout_mlp, fused_mlp_chain_reference, fused_mlp_chunked)
    from vitlens_tpu_torch.ops.int8_matmul import (
        dequant_reference, int8_matmul, int8_matmul_dequant, int8_matmul_reference,
        int8_quantize, int8_quantize_reference)
    from vitlens_tpu_torch.ops.row_gather import row_gather, row_gather_reference

    m = 257 * B * 3  # the quantized B64 x 3 clips encode's rows
    for label, (m_, k, n) in (("quantized trunk fc", (m, 1024, 4096)),
                              ("quantized trunk qkv", (m, 1024, 3072)),
                              ("quantized trunk out", (m, 1024, 1024)),
                              ("quantized trunk proj", (m, 4096, 1024)),
                              ("prototype", (4096, 4096, 4096))):
        a, b, b_t = int8_inputs(torch, g, m_, k, n)
        lib_ms = cuda_ms(lambda: torch._int_mm(a, b))
        k_ms, p_ms = paired_ms(lambda: int8_matmul(a, b, b_t),
                               lambda: int8_matmul_reference(a, b), plain_iters=3)
        bd, by = int8_bound(m_, k, n)
        timings["int8_matmul"].append(
            {"shape": f"INT32, {label} M={m_} K={k} N={n}", "ms": k_ms,
             "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
             "library_ms": lib_ms, "tops": 2 * m_ * k * n / k_ms / 1e9})
        xs = torch.rand(m_, 1, generator=g, device="cuda") * 0.02 + 1e-4
        ws = torch.rand(1, n, generator=g, device="cuda") * 0.01 + 1e-5
        bias = torch.randn(n, generator=g, device="cuda")
        k_ms, p_ms = paired_ms(
            lambda: int8_matmul_dequant(a, b, xs, ws, bias, torch.bfloat16, b_t),
            lambda: dequant_reference(int8_matmul_reference(a, b), xs, ws, bias,
                                      torch.bfloat16), plain_iters=3)
        bd, by = dequant_bound(m_, k, n)
        timings["int8_matmul_dequant"].append(
            {"shape": f"DEQUANT to bf16 with bias, {label} M={m_} K={k} N={n}",
             "ms": k_ms, "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
             "library_ms": lib_ms, "tops": 2 * m_ * k * n / k_ms / 1e9})
        del a, b, b_t
    for label, k in (("qkv, out and fc inputs", 1024), ("proj input", 4096)):
        x = quant_rows(torch, g, m, k, torch.bfloat16)
        k_ms, p_ms = paired_ms(lambda: int8_quantize(x),
                               lambda: int8_quantize_reference(x), plain_iters=5)
        bd, by = quantize_bound(m, k, 2)
        timings["int8_quantize"].append(
            {"shape": f"{label} [{m},{k}] bf16", "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bd, "bound_by": by, "library_ms": None})
        del x
    v, d, j = 49408, 512, 9856
    table = torch.randn(v, d, generator=g, device="cuda").bfloat16()
    ids = torch.randint(0, v, (j,), generator=g, device="cuda", dtype=torch.int32)

    def gather():
        return row_gather(table, ids)

    def index_select():
        return torch.index_select(table, 0, ids)

    wrapper_ms, p_ms = paired_ms(gather, lambda: row_gather_reference(table, ids),
                                 iters=100, plain_iters=100)
    bd, by = gather_bound(j, 2 * d)
    # the kernel's own time is its device time; back to back through the
    # Python wrapper the host's enqueue can be the longer
    timings["row_gather"].append(
        {"shape": f"table [{v},{d}] bf16, {j} ids", "ms": device_ms(torch, gather),
         "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
         "library_ms": cuda_ms(index_select, 100), "wrapper_ms": wrapper_ms,
         "library_device_ms": device_ms(torch, index_select),
         "host_us": host_us(torch, gather),
         "library_host_us": host_us(torch, index_select)})
    m, d, h = 257 * B, 1024, 4096
    x, *mlp = mlp_inputs(torch, g, m, d, h)
    proj = outproj_inputs(torch, g, m, d)
    ctx, wo, bo = proj
    # cuBLAS's products alone (the LayerNorm, the activation and the adds
    # left out), as kernel 1's rows give them: the MLP's two, and with the
    # out-projection three
    lnw, lnb, w1, b1, w2, b2 = mlp
    y = torch.nn.functional.layer_norm(x.float(), (d,), lnw, lnb).bfloat16()
    hid = torch.empty(m, h, dtype=torch.bfloat16, device="cuda")
    b1h, b2h, boh = b1.bfloat16(), b2.bfloat16(), bo.to(x.dtype)
    two_ms = cuda_ms(lambda: (torch.addmm(b1h, y, w1, out=hid),
                              torch.addmm(b2h, hid, w2)))
    three_ms = cuda_ms(lambda: (torch.addmm(boh, ctx, wo),
                                torch.addmm(b1h, y, w1, out=hid),
                                torch.addmm(b2h, hid, w2)))
    del y, hid

    def today():  # the library's out-projection + residual, then kernel 1
        return fused_mlp(x + (ctx @ wo + bo.to(x.dtype)), *mlp, act="gelu")

    for act in ("gelu_tanh", "gelu"):
        k_ms, p_ms = paired_ms(
            lambda: fused_mlp_chunked(x, *mlp, act=act),
            lambda: fused_mlp_chain_reference(x, *mlp, act=act), plain_iters=3)
        bd, by = chain_bound(m, d, h, False)
        timings["fused_mlp_chunked"].append(
            {"shape": f"M={m} D={d} H={h} {act}", "ms": k_ms, "plain_ms": p_ms,
             "gemm_only_ms": two_ms, "bound_ms": bd, "bound_by": by,
             "library_ms": None, "tflops": 4 * m * d * h / k_ms / 1e9,
             **({"three_launch_ms": cuda_ms(lambda: fused_mlp(x, *mlp, act="gelu"))}
                if act == "gelu" else {})})
        k_ms, p_ms = paired_ms(
            lambda: fused_attnout_mlp(x, *proj, *mlp, act=act),
            lambda: fused_mlp_chain_reference(x, *mlp, act=act, outproj=proj),
            plain_iters=3)
        bd, by = chain_bound(m, d, h, True)
        timings["fused_attnout_mlp"].append(
            {"shape": f"M={m} D={d} H={h} {act}", "ms": k_ms, "plain_ms": p_ms,
             "gemm_only_ms": three_ms, "bound_ms": bd, "bound_by": by,
             "library_ms": None,
             "tflops": (2 * m * d * d + 4 * m * d * h) / k_ms / 1e9,
             **({"today_split_ms": cuda_ms(today)} if act == "gelu" else {})})


SERVE_COS_MIN = 0.999  # a served reply against a direct encode of the same items
LENS_FILE = ("audio", "pc", "depth", "eeg", "video")  # the merged export's towers
FBANK_TOL = 1e-3       # cuFFT against pocketfft, on the normalised fbank


def _tone(np, rate, seconds, channels, seed):
    """A tone over noise 30 dB down: float64 [channels, T] in [-1, 1)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(rate * seconds)) / rate
    f = 220.0 * (1 + seed % 5) + 110.0 * np.arange(channels)[:, None]
    return 0.4 * np.sin(2 * np.pi * f * t) + 0.013 * rng.randn(channels, t.size)


def write_inputs(torch, np, root):
    """Phase 4v's files: WAV (16 kHz mono 5 s, 44.1 kHz stereo 12 s, 8 kHz
    1.5 s), one FLAC (the tests' minimal writer), PNG and JPEG images at
    320 x 240 in RGB and grayscale, .npy clouds of 9000 points, disparity
    maps (a 240 x 320 .npy, a 300 x 200 16-bit .png), an EEG recording [128,
    500] as .pt, a directory of 12 JPEG frames at 320 x 240, and the
    reference-layout checkpoints: a merged export (vitlens.{audio, pc,
    depth, eeg, video}.*) and a CLIP file (visual.* and the text keys),
    fp16, from a seeded generator."""
    from PIL import Image

    from tools.reference_layout import (clip_state_dict, merged_state_dict,
                                        pcm_from_float, vision_tower_state_dict,
                                        write_flac, write_wav)
    from vitlens_tpu_torch.config import make_model_config

    f = {}
    for name, (rate, secs, ch) in {"wav16k": (16000, 5.0, 1),
                                   "wav44k": (44100, 12.0, 2),
                                   "wav8k": (8000, 1.5, 1),
                                   "wav10s": (16000, 10.0, 1)}.items():
        f[name] = os.path.join(root, name + ".wav")
        write_wav(f[name], pcm_from_float(_tone(np, rate, secs, ch, len(f)), 16), rate)
    f["flac"] = os.path.join(root, "a.flac")
    write_flac(f["flac"], pcm_from_float(_tone(np, 16000, 3.0, 2, 7), 16), 16000,
               16, "fixed", 2, "mid_side")
    rng = np.random.RandomState(SEED)
    yy, xx = np.mgrid[0:240, 0:320]
    rgb = np.stack([xx / 320, yy / 240, (xx + yy) / 560], -1) * 200
    rgb = np.clip(rgb + rng.randint(0, 55, rgb.shape), 0, 255).astype(np.uint8)
    for ext in ("png", "jpg"):
        for mode in ("RGB", "L"):
            f[f"{ext}_{mode}"] = os.path.join(root, f"im_{mode}.{ext}")
            Image.fromarray(rgb, "RGB").convert(mode).save(f[f"{ext}_{mode}"])
    for i in range(2):
        f[f"npy{i}"] = os.path.join(root, f"cloud{i}.npy")
        np.save(f[f"npy{i}"], (rng.randn(9000, 3) * 0.3).astype(np.float32))
    # disparity: a ramp across the clamp range (0.01 .. 75) with noise
    f["depth_npy"] = os.path.join(root, "disparity.npy")
    np.save(f["depth_npy"], (80 * (xx / 320) * (yy / 240)
                             + 3 * rng.rand(240, 320)).astype(np.float32))
    f["depth_png"] = os.path.join(root, "disparity.png")
    Image.fromarray((rng.rand(300, 200) * 5e4).astype(np.uint16)).save(f["depth_png"])
    f["eeg_pt"] = os.path.join(root, "eeg.pt")
    t = np.arange(500) / 1000.0
    eeg = np.sin(2 * np.pi * (5 + np.arange(128))[:, None] * t) + 0.3 * rng.randn(128, 500)
    torch.save(torch.from_numpy(eeg.astype(np.float32)), f["eeg_pt"])
    f["frames"] = os.path.join(root, "clip_frames")
    os.makedirs(f["frames"])
    for i in range(12):  # the image above, drifting a few pixels a frame
        Image.fromarray(np.roll(rgb, 7 * i, axis=1), "RGB").save(
            os.path.join(f["frames"], f"{i:04d}.jpg"))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    half = torch.float16
    towers = {m: vision_tower_state_dict(make_model_config("ViT-L-14", m).tower,
                                         g, half) for m in LENS_FILE}
    merged = merged_state_dict(towers)
    clip = clip_state_dict(make_model_config("ViT-L-14", "image"), g, half)
    f["all"] = os.path.join(root, "vitlensL_merged.pt")
    f["clip"] = os.path.join(root, "clip_vitl14.pt")
    torch.save({"epoch": 1, "state_dict": merged}, f["all"])
    torch.save(clip, f["clip"])
    return f, merged, clip


def _post(port, payload, timeout=600):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/encode", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _healthz(port):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=60) as r:
        return json.loads(r.read())


def _serve(make_server, model, max_batch, max_wait_ms):
    import threading

    srv = make_server(model, port=0, max_batch=max_batch, max_wait_ms=max_wait_ms)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th


def _stop(srv, th):
    """Stop accepting, drain, close; both workers must have exited."""
    srv.shutdown()
    srv.encoder.close()
    srv.server_close()
    th.join(30)
    enc = srv.encoder
    alive = [t.name for t in (enc._worker, enc._pre_worker, th)
             if t is not None and t.is_alive()]
    if alive:
        fail(f"threads still alive after the drain: {alive}")


def vitlensG_phase(torch, np, counters, totals):
    """Phase 4g: ViTLens("vitlensG", ("pc", "text")) on the card in bf16
    (weights stored in bf16, as the serve CLI stores vitlensG's), loaded
    from reference-layout checkpoints that tools/reference_layout.py writes
    (fp16): the PNSA tokenizer over 10000 xyz + rgb points, the bigG Lens
    and the ViT-bigG-14 trunk with its first 16 of 48 blocks skipped (they
    still hold the file's weights), and the bigG text tower. B = 1 and B = 2
    encodes of raw .npy clouds of 10000 x 6 and of xyz-only clouds
    (OpenShape's 0.4 grey fills their rgb), with the launches per request
    from tower_launches (1 FPS, 32 trunk blocks, 4 Lens layers; no point
    encoder) and cosine >= 0.99 against the same weights in fp32 on the CPU,
    given the processor's clouds rounded through bf16 as the card sees
    them; a text request (32 fused MLP); then one HTTP request of two
    clouds and a caption through make_server, cosine >= 0.999 against the
    direct encodes. Returns the model, for phase 5."""
    import tempfile

    from tools.reference_layout import (text_tower_state_dict,
                                        vision_tower_state_dict)
    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.config import make_model_config
    from vitlens_tpu_torch.serve import make_server
    from vitlens_tpu_torch.train.openshape import vitlensG_tower_config

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="vitlens_4g_")
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    tcfg, cfg = vitlensG_tower_config(), make_model_config("ViT-bigG-14", "image")
    files = {"pc": os.path.join(root, "vitlensG_pc.pt"),
             "text": os.path.join(root, "bigG_text.pt")}
    sd = vision_tower_state_dict(tcfg, g, torch.float16)
    torch.save(sd, files["pc"])
    want_w = {"sa.0.conv.w": sd["visual_adapter.sa.mlp_convs.0.weight"][..., 0, 0].T,
              "trunk.blocks.0.attn.qkv_w":  # a skipped block
                  sd["transformer.resblocks.0.attn.in_proj_weight"].T}
    del sd
    torch.save(text_tower_state_dict(cfg.text, cfg.embed_dim, g, torch.float16),
               files["text"])
    rng = np.random.RandomState(SEED + 7)
    for i in range(2):
        files[f"npy{i}"] = os.path.join(root, f"cloud{i}.npy")
        np.save(files[f"npy{i}"], np.concatenate(
            [rng.randn(10000, 3) * 0.4, rng.rand(10000, 3)], 1).astype(np.float32))
    files["xyz"] = os.path.join(root, "xyz_only.npy")
    np.save(files["xyz"], (rng.randn(10000, 3) * 0.4).astype(np.float32))
    t_files = time.time() - t0

    t0 = time.time()
    model = ViTLens("vitlensG", ("pc", "text"), device="cuda",
                    compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                    seed=SEED, checkpoints={"pc": files["pc"],
                                            "text": files["text"]})
    torch.cuda.synchronize()
    t_load = time.time() - t0
    tower = model.towers["pc"]
    got_w = {"sa.0.conv.w": tower.adapter.sa[0].conv.w,
             "trunk.blocks.0.attn.qkv_w": tower.trunk.blocks[0].attn.qkv_w}
    for name, want in want_w.items():
        if not torch.equal(got_w[name].cpu(), want.float().to(torch.bfloat16)):
            fail(f"4g: loaded {name} differs from the checkpoint's")
    proc = model.processors["pc"]
    if (proc.n, proc.channels) != (10000, 6) or tower.cfg.point.tokenizer != "pnsa":
        fail(f"4g: pc processor {proc.n} x {proc.channels}, tokenizer "
             f"{tower.cfg.point.tokenizer}")
    n_text = model.towers["text"].cfg.layers
    want = {"pc": tower_launches(tower.cfg, fps=1),
            "text": launch_counts(fused_mlp=n_text)}
    if (want["pc"]["fused_mlp"], want["pc"]["flash_attention"]) != (32, 40):
        fail(f"4g: launches derived from the vitlensG pc config {want['pc']}")
    requests = [("pc", [files["npy0"]]), ("pc", [files["npy0"], files["npy1"]]),
                ("pc", [files["xyz"]]), ("pc", [files["npy1"], files["xyz"]]),
                ("text", ["a wooden chair with four legs"])]
    outs, per_req = [], []
    for m, items in requests:
        emb, counts = run_counted(torch, counters, totals,
                                  lambda: model.encode({m: items})[m])
        if counts != want[m]:
            fail(f"4g {m} B={len(items)}: launches {counts}, expected {want[m]}")
        if (tuple(emb.shape) != (len(items), 1280)
                or not torch.isfinite(emb).all()):
            fail(f"4g {m} B={len(items)}: shape {tuple(emb.shape)} or "
                 "non-finite values")
        outs.append((m, items, emb))
        per_req.append((m, len(items), counts["fused_mlp"],
                        counts["flash_attention"], counts["fps"]))

    t0 = time.time()
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    ref.compute_dtype = torch.float32
    cos = {}
    for m, items, emb in outs:
        if m == "pc":  # the processor's clouds as the card's bf16 cast sees them
            x = torch.from_numpy(proc(items)).bfloat16().float()
            ref_emb = ref.encode({"pc": x}, preprocessed=True)["pc"]
        else:
            ref_emb = ref.encode({m: items})[m]
        label = f"{m} B={len(items)}" + (" xyz-only" if files["xyz"] in items else "")
        cos[label] = cos_min(torch, emb, ref_emb)
    t_cpu = time.time() - t0
    del ref
    if min(cos.values()) < COS_MIN:
        fail(f"4g: card bf16 vs CPU fp32 cosines {cos} < {COS_MIN}")

    srv, th = _serve(make_server, model, 4, 20)
    try:
        items = [files["npy0"], files["xyz"]]
        out = _post(srv.server_address[1], {"inputs": {
            "pc": items, "text": ["a wooden chair with four legs"]}})
    finally:
        _stop(srv, th)
    served = {m: cos_min(torch, torch.tensor(out["embeddings"][m]),
                         model.encode({m: v})[m])
              for m, v in (("pc", items), ("text", ["a wooden chair with four legs"]))}
    if min(served.values()) < 0.999:
        fail(f"4g: served replies vs direct encodes: cosines {served}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4g vitlensG pc] ViTLens('vitlensG', ('pc', 'text')) bf16, weights "
          f"bf16, from reference-layout fp16 checkpoints (written in "
          f"{t_files:.1f} s, loaded in {t_load:.1f} s; the skipped block 0 "
          f"holds the file's weights): requests (modality, B, launches "
          f"(mlp, attn, fps)) {per_req}; cosine vs CPU fp32 (took "
          f"{t_cpu:.1f} s): " + " ".join(f"{k} {v:.6f}" for k, v in cos.items())
          + "; one HTTP request (2 clouds, one xyz-only, and a caption): "
          + " ".join(f"{k} {v:.6f}" for k, v in served.items()), flush=True)
    return model


def served_phase(torch, np, counters, totals, card):
    """Phase 4v: vitlensL with every ported modality, loaded from
    reference-layout checkpoints, encodes raw files on the card and is
    served over HTTP. Returns what phase 5 times."""
    import tempfile
    import threading

    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.ops.fbank import fbank_fixed_length
    from vitlens_tpu_torch.serve import make_server

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="vitlens_4v_")
    files, merged, clip = write_inputs(torch, np, root)
    t_files = time.time() - t0
    mods = ("image", "tactile", "depth", "audio", "eeg", "video", "pc", "text")
    ckpts = {"all": files["all"], "image": files["clip"],
             "tactile": files["clip"], "text": files["clip"]}
    t0 = time.time()
    model = ViTLens("vitlensL", mods, device="cuda", compute_dtype=torch.bfloat16,
                    seed=SEED, checkpoints=ckpts, batch_buckets=(1, 4, 8))
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    ref = ViTLens("vitlensL", mods, device="cpu", seed=SEED, checkpoints=ckpts)
    t_cpu = time.time() - t0

    # a handful of loaded tensors against the file's, after the cast
    t = model.towers
    p = "transformer.resblocks.0."
    last = f"transformer.resblocks.{len(t['text'].trunk.blocks) - 1}."
    dim = t["text"].text_projection.shape[1]
    pairs = {
        "image conv1": (t["image"].adapter.conv1.w,
                        clip["visual.conv1.weight"].float().flatten(1).T),
        "tactile ln_pre": (t["tactile"].ln_pre.scale, clip["visual.ln_pre.weight"]),
        "audio qkv_w[0]": (t["audio"].trunk.blocks[0].attn.qkv_w,
                           merged["vitlens.audio." + p + "attn.in_proj_weight"].float().T),
        "audio latents": (t["audio"].perceiver.latents,
                          merged["vitlens.audio.perceiver.latents"]),
        "pc bn1 mean": (t["pc"].adapter.encoder.bn1.mean,
                        merged["vitlens.pc.visual_adapter.encoder.first_conv.1.running_mean"]),
        "depth conv1": (t["depth"].adapter.conv1.w,
                        merged["vitlens.depth.visual_adapter.conv1.weight"]
                        .float().flatten(1).T),
        "eeg proj w": (t["eeg"].adapter.proj.w,
                       merged["vitlens.eeg.visual_adapter.proj.weight"]
                       .float().flatten(1).T),
        "video ltpos": (t["video"].adapter.ltpos,
                        merged["vitlens.video.ltpos.weight"]),
        "video conv1": (t["video"].adapter.conv1.w,
                        merged["vitlens.video.conv1.weight"].float().flatten(1).T),
        "text token_embedding": (t["text"].token_embedding,
                                 clip["token_embedding.weight"]),
        "text fc w[last]": (t["text"].trunk.blocks[-1].mlp.fc.w,
                            clip[last + "mlp.c_fc.weight"].float().T)}
    for name, (got, want) in pairs.items():
        if not torch.equal(got.cpu(), want.float().to(got.dtype)):
            fail(f"4v: loaded {name} differs from the checkpoint's")
    del merged, clip

    # B = 1 (and one B = 3 audio, one B = 2 depth) encodes from files, counted
    n_text = t["text"].cfg.layers
    want = {m: tower_launches(t[m].cfg) for m in mods if m not in ("pc", "text")}
    want["pc"] = tower_launches(t["pc"].cfg, fps=1, point_encoder=1)
    want["text"] = launch_counts(fused_mlp=n_text)
    derived = {m: (want[m]["fused_mlp"], want[m]["flash_attention"])
               for m in ("depth", "eeg", "video")}
    if derived != {"depth": (24, 24), "eeg": (24, 26), "video": (24, 28)}:
        fail(f"4v: launches derived from the vitlensL configs {derived}")
    requests = [("image", [files["png_RGB"]]), ("tactile", [files["jpg_L"]]),
                ("depth", [files["depth_npy"], files["depth_png"]]),
                ("audio", [files["wav44k"]]),
                ("audio", [files["wav16k"], files["wav8k"], files["flac"]]),
                ("eeg", [files["eeg_pt"]]), ("video", [files["frames"]]),
                ("pc", [files["npy0"]]),
                ("text", ["a dog barking in the rain"])]
    per_req, cos = [], {}
    for m, items in requests:
        emb, counts = run_counted(torch, counters, totals,
                                  lambda: model.encode({m: items})[m])
        per_req.append((m, len(items), counts["fused_mlp"], counts["flash_attention"],
                        counts["fps"], counts["point_encoder"]))
        if counts != want[m]:
            fail(f"4v {m} from files: launches {counts}, expected {want[m]}")
        if (tuple(emb.shape) != (len(items), dim) or not torch.isfinite(emb).all()
                or (emb.float().norm(dim=-1) - 1).abs().max() > 1e-3):
            fail(f"4v {m} from files: shape {tuple(emb.shape)}, non-finite "
                 "values or norms off 1")
        if m == "pc":  # the card's tower rounds the cloud to bf16 before FPS
            x = torch.from_numpy(model.processors["pc"](items))
            want_emb = ref.encode({"pc": x.bfloat16().float()}, preprocessed=True)["pc"]
        else:
            want_emb = ref.encode({m: items})[m]
        cos[f"{m} B={len(items)}"] = cos_min(torch, emb, want_emb)
    del ref
    if min(cos.values()) < COS_MIN:
        fail(f"4v: card bf16 vs CPU fp32 from files: min cosine {cos} < {COS_MIN}")
    print(f"[4v files] vitlensL {mods} from reference-layout checkpoints "
          f"(merged vitlens.{{{','.join(LENS_FILE)}}}. export, CLIP visual. + "
          f"text file; "
          f"files written in {t_files:.1f} s, card model built and loaded in "
          f"{t_card:.1f} s, CPU fp32 copy in {t_cpu:.1f} s); {len(pairs)} loaded "
          f"tensors equal the files'; requests from files (modality, B, mlp, "
          f"attn, fps, encoder) {per_req}; min cosine vs CPU fp32: "
          + " ".join(f"{k} {v:.6f}" for k, v in cos.items()), flush=True)

    # the on-device fbank against the host processor's, same samples
    proc, tower = model.processors["audio"], t["audio"]
    from vitlens_tpu_torch.data.audio_decode import load_audio_file

    clips = proc.clips(*load_audio_file(files["wav44k"]))  # [3, 80000]
    host = torch.from_numpy(proc.fbank(clips))
    a = tower.cfg.audio
    wave = torch.from_numpy(clips).cuda()
    dev = fbank_fixed_length(wave, target_length=a.target_length,
                             sample_frequency=float(a.sampling_rate),
                             num_mel_bins=a.mel_bins).cpu()
    d = (dev - host).abs().max().item()
    if d > FBANK_TOL:
        fail(f"4v: on-device fbank vs host: max |d| {d} > {FBANK_TOL}")
    with torch.inference_mode():
        f_wave = tower(wave, torch.bfloat16)
        f_host = tower(host.cuda(), torch.bfloat16)
    fcos = cos_min(torch, f_wave, f_host)
    if fcos < COS_MIN:
        fail(f"4v: waveform-branch features vs host-fbank features: cosine {fcos}")
    print(f"[4v fbank] {card} | [3, 80000] waveforms: on-device fbank (cuFFT) "
          f"vs the host AudioProcessor's (CPU): max |d| {d:.3e} (<= "
          f"{FBANK_TOL}) on the normalised fbank; tower features from the "
          f"waveform vs from the host fbank: min cosine {fcos:.6f}", flush=True)

    # served: about 12 concurrent requests mixing the five modalities
    srv, th = _serve(make_server, model, 8, 50)
    port = srv.server_address[1]
    clouds = [np.load(files[f"npy{i}"]) for i in range(2)]
    reqs = [("text", ["a bird singing"]), ("text", ["rain", "a siren wailing"]),
            ("text", ["an old car"]),
            ("image", [files["png_RGB"]]), ("image", [files["jpg_RGB"], files["png_L"]]),
            ("tactile", [files["jpg_L"]]), ("tactile", [files["png_RGB"]]),
            ("depth", [files["depth_npy"]]), ("depth", [files["depth_png"]]),
            ("audio", [files["wav16k"]]), ("audio", [files["flac"]]),
            ("audio", [files["wav8k"]]),
            ("eeg", [files["eeg_pt"]]), ("video", [files["frames"]]),
            ("pc", [clouds[0].tolist()]), ("pc", [clouds[1].tolist()])]
    replies = [None] * len(reqs)

    def ask(i):
        m, items = reqs[i]
        try:
            replies[i] = _post(port, {"inputs": {m: items}})
        except Exception as e:  # noqa: BLE001 - reported below
            replies[i] = e

    for c in counters.values():
        c.launches = 0
    threads = []
    t0 = time.time()
    for m in mods:
        # one burst a modality, the bursts further apart than the window
        for i, (rm, _) in enumerate(reqs):
            if rm == m:
                threads.append(threading.Thread(target=ask, args=(i,)))
                threads[-1].start()
        time.sleep(0.15)
    for th_ in threads:
        th_.join(600)
    served_s = time.time() - t0
    served_counts = {name: c.launches for name, c in counters.items()}
    for name, n in served_counts.items():
        totals[name] += n
    health = _healthz(port)
    _stop(srv, th)
    scos = []
    for (m, items), reply in zip(reqs, replies):
        if not isinstance(reply, dict):
            fail(f"4v serve: {m} request failed: {reply!r}")
        got = torch.tensor(reply["embeddings"][m])
        direct = [np.asarray(x, np.float32) for x in items] if m == "pc" else items
        scos.append(cos_min(torch, got, model.encode({m: direct})[m]))
    stats = health["stats"]
    if min(scos) < SERVE_COS_MIN:
        fail(f"4v serve: replies vs direct encodes: cosines {scos} < {SERVE_COS_MIN}")
    if not stats["batches"] < len(reqs):
        fail(f"4v serve: {stats['batches']} batches for {len(reqs)} requests: "
             "nothing was coalesced")
    if (health["device_name"] != torch.cuda.get_device_name(0)
            or not health["device"].startswith("cuda")):
        fail(f"4v serve: /healthz names {health['device']} {health['device_name']}")
    if health["modalities"] != list(mods):
        fail(f"4v serve: /healthz lists {health['modalities']}, not {list(mods)}")
    print(f"[4v serve] {card} | {len(reqs)} concurrent HTTP requests (text, "
          f"image, tactile, depth .npy/.png, audio, EEG .pt paths, a video "
          f"frame directory, pc numeric items) in {served_s:.2f} s: "
          f"{stats['batches']} batches, {stats['items']} items; min cosine of a "
          f"reply vs a direct encode {min(scos):.6f} (>= {SERVE_COS_MIN}); "
          f"launches {dict((k, v) for k, v in served_counts.items() if v)}; "
          f"/healthz device {health['device']} ({health['device_name']}), "
          f"latency {health['latency']}; after shutdown and close both "
          f"workers have exited", flush=True)

    print(f"[4v cli] {card} | {run_cli(torch, model, files, root)}", flush=True)
    return {"model": model, "files": files, "root": root}


def run_cli(torch, model, files, tmp):
    """python -m vitlens_tpu_torch.cli.serve on the card with the depth,
    EEG, video and text towers loaded from phase 4v's reference-layout
    checkpoints: answers one request of each (a disparity .npy, an EEG .pt,
    a frame directory, a caption) at cosine >= SERVE_COS_MIN against
    ``model``'s direct encode of the same items (the same files' weights),
    drains on SIGTERM and exits 0. Its log goes to ``tmp``."""
    import re
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    log = os.path.join(tmp, "serve_cli.log")
    cmd = [sys.executable, "-m", "vitlens_tpu_torch.cli.serve", "--modalities",
           "depth", "eeg", "video", "text", "--ckpt", f"all={files['all']}",
           "--ckpt", f"text={files['clip']}", "--max-batch", "2", "--port", "0"]
    items = {"depth": [files["depth_npy"]], "eeg": [files["eeg_pt"]],
             "video": [files["frames"]], "text": ["a dog"]}
    t0 = time.time()
    with open(log, "w") as out:
        p = subprocess.Popen(cmd, cwd=root, stdout=out, stderr=subprocess.STDOUT)
        try:
            port = None
            while time.time() - t0 < 300 and port is None:
                m = re.search(r"listening on http://[^:]+:(\d+)", open(log).read())
                if m:
                    port = int(m.group(1))
                elif p.poll() is not None:
                    fail(f"serve CLI exited {p.returncode}: {open(log).read()[-1500:]}")
                else:
                    time.sleep(0.5)
            if port is None:
                fail("serve CLI never printed its port")
            t_up = time.time() - t0
            cos = {}
            for m, x in items.items():
                reply = _post(port, {"inputs": {m: x}})
                if len(reply["embeddings"][m]) != 1 or reply["dim"] != 768:
                    fail(f"serve CLI {m} reply: {str(reply)[:200]}")
                cos[m] = cos_min(torch, torch.tensor(reply["embeddings"][m]),
                                 model.encode({m: x})[m])
            p.send_signal(signal.SIGTERM)
            rc = p.wait(timeout=120)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    if min(cos.values()) < SERVE_COS_MIN:
        fail(f"serve CLI replies vs direct encodes: cosines {cos} < {SERVE_COS_MIN}")
    text = open(log).read()
    drained = re.search(r"vitlens-serve: drained, exiting \(served 4 items.*", text)
    if rc != 0 or "draining" not in text or not drained:
        fail(f"serve CLI: exit {rc}, log {text[-1500:]}")
    return (f"{' '.join(cmd[1:6])} ... (merged and CLIP files): up (warmed) in "
            f"{t_up:.1f} s, answered one depth, EEG, video and text request, "
            f"cosine vs a direct encode "
            + " ".join(f"{m} {c:.6f}" for m, c in cos.items())
            + f", exit {rc} on SIGTERM: {drained.group(0)!r}")


def served_timings(torch, np, card, ctx):
    """Phase 5's timings of the served path: the B64 image, depth, EEG and
    video encodes (arrays given), the host processors, the on-device fbank
    at [192, 80000], and a closed-loop served run (64 audio requests of one
    5 s WAV each from 16 client threads at max_batch 64)."""
    import threading

    from vitlens_tpu_torch.data.processors import (AudioProcessor,
                                                   DepthProcessor, EEGProcessor,
                                                   ImageProcessor)
    from vitlens_tpu_torch.data.video_processors import VideoProcessor
    from vitlens_tpu_torch.ops.fbank import fbank_fixed_length
    from vitlens_tpu_torch.serve import make_server

    model, files = ctx["model"], ctx["files"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    hw = model.towers["image"].cfg.arch.image_size
    img64 = torch.randn(B, 3, hw, hw, generator=g, device="cuda")
    def image64():
        return model.encode({"image": img64}, preprocessed=True)["image"]

    rates = {"image": encode_rate(
        torch, card, f"image encode B{B} bf16 (preprocessed [B, 3, {hw}, {hw}])",
        image64, B)}
    profile_encode(torch, card, f"B{B} image encode", image64)
    del img64
    for m in ("depth", "eeg", "video"):
        x = torch.randn((B,) + model._warmup_sample(m, 1).shape[1:], generator=g,
                        device="cuda")

        def encode(m=m, x=x):
            return model.encode({m: x}, preprocessed=True)[m]

        rates[m] = encode_rate(torch, card, f"{m} encode B{B} bf16 (preprocessed "
                               f"{list(x.shape)})", encode, B)
        if m == "video":
            profile_encode(torch, card, f"B{B} video encode", encode)
        del x, encode

    def host_ms(fn, runs=5):
        fn()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times), times

    aud, img = AudioProcessor(), ImageProcessor()
    a_ms, a_all = host_ms(lambda: aud([files["wav10s"]]))
    i_ms, i_all = host_ms(lambda: img([files["jpg_RGB"]]), runs=20)
    print(f"[5 timing] {card} | host AudioProcessor, one 10 s 16 kHz WAV -> "
          f"[1, 3, 512, 128] (decode, 3 clips, CPU fbank; torch "
          f"{torch.get_num_threads()} threads): {a_ms:.2f} ms best of 5, all "
          f"{[round(x, 2) for x in a_all]}; host ImageProcessor, one 320 x 240 "
          f"JPEG -> [1, 3, 224, 224]: {i_ms:.3f} ms best of 20", flush=True)
    host = {"DepthProcessor, one 240 x 320 .npy disparity -> [1, 1, 224, 224]":
            (DepthProcessor(), files["depth_npy"], 20),
            "DepthProcessor, one 300 x 200 16-bit .png -> [1, 1, 224, 224]":
            (DepthProcessor(), files["depth_png"], 20),
            "EEGProcessor, one [128, 500] .pt -> [1, 128, 512]":
            (EEGProcessor(), files["eeg_pt"], 20),
            "VideoProcessor, one directory of 12 320 x 240 JPEG frames -> "
            "[1, 8, 3, 224, 224]": (VideoProcessor(), files["frames"], 5)}
    for label, (proc, path, runs) in host.items():
        ms, _ = host_ms(lambda: proc([path]), runs=runs)
        print(f"[5 timing] {card} | host {label}: {ms:.3f} ms best of {runs}",
              flush=True)
    w192 = torch.randn(3 * B, 80000, generator=g, device="cuda") * 0.1
    fb_ms = cuda_ms(lambda: fbank_fixed_length(w192))
    # the bound: each waveform read and the fbank written once, or the
    # operations (a 512-point real FFT ~2.5 N log2 N, the power spectrum
    # and the mel product) at the fp32 peak
    frames = 1 + (80000 - 400) // 160
    fb_ops = 3 * B * frames * (2.5 * 512 * 9 + 3 * 256 + 2 * 256 * 128)
    fb_bound, fb_by = bound(fb_ops, w192.numel() * 4 + 3 * B * 512 * 128 * 4,
                            PEAK_FP32)
    print(f"[5 timing] {card} | on-device fbank [{3 * B}, 80000] -> "
          f"[{3 * B}, 512, 128] fp32 (plain PyTorch: unfold, cuFFT rfft, the "
          f"mel matmul): {fb_ms:.4f} ms, bound {fb_bound:.4f} ms ({fb_by})",
          flush=True)

    srv, th = _serve(make_server, model, B, 50)
    port = srv.server_address[1]
    _post(port, {"inputs": {"audio": [files["wav16k"]]}})  # warm the path
    errors = []

    def client():
        for _ in range(4):
            try:
                _post(port, {"inputs": {"audio": [files["wav16k"]]}})
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    clients = [threading.Thread(target=client) for _ in range(16)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(600)
    wall = time.perf_counter() - t0
    health = _healthz(port)
    _stop(srv, th)
    if errors:
        fail(f"served run: {len(errors)} requests failed: {errors[0]!r}")
    st, lat = health["stats"], health["latency"]
    print(f"[5 timing] {card} | served closed loop: 64 audio requests (one 5 s "
          f"16 kHz WAV each, 3 clips) from 16 client threads, max_batch {B}, "
          f"max_wait 50 ms: {64 / wall:.2f} requests/s ({wall:.2f} s), "
          f"{st['batches'] - 1} batches (mean {63 / max(1, st['batches'] - 1):.1f} "
          f"items, the warm request aside), latency p50 {lat['p50_ms']} ms, "
          f"p95 {lat['p95_ms']} ms (/healthz, the warm request included)",
          flush=True)
    rates["served_rps"] = 64 / wall
    return rates


# -- phase 4x: the training CLI ------------------------------------------------

CLI_CLIPS = 24      # AudioSet-style train clips of 5-10 s (every fourth FLAC)
CLI_EPOCHS = 2      # run (a); run (b) resumes into a third
CLI_ARGS = ("--modality", "audio", "--model", "ViT-L-14", "--train-data",
            "audioset@train", "--val-data", "esc50@fold-1::audiocaps@test",
            "--n-tower", "2", "--align-to", "text", "--unlock-cls",
            "--precision", "bf16", "--batch-size", "8", "--accum-freq", "2",
            "--log-every-n-steps", "1", "--seed", "0", "--warmup", "2",
            "--lr", "1e-4")


def write_cli_inputs(torch, np, root):
    """Phase 4x's files under ``root``: CLI_CLIPS AudioSet-style clips (16
    kHz mono, 5-10 s, every fourth one FLAC) with audioset_train.json and the
    class CSV (4 classes); an ESC50-style fold of 8 clips over 4 classes with
    its label JSON; an AudioCaps-style test tsv of 6 rows with its texts
    JSON; and a reference-layout vitlensL tri file from a seeded generator
    (the audio tower under visual., the image tower under image., the text
    tower, logit_scale; fp16). -> (env, path of the pretrained file)."""
    from tools.reference_layout import (pcm_from_float, text_tower_state_dict,
                                        vision_tower_state_dict, write_flac,
                                        write_wav)
    from vitlens_tpu_torch.config import image_tower_config, make_model_config

    meta = os.path.join(root, "meta", "modal_audio", "data")
    os.makedirs(meta)
    os.makedirs(os.path.join(root, "audio"))
    rng = np.random.RandomState(SEED + 13)
    paths = []
    for i in range(CLI_CLIPS):
        secs = 5.0 + 5.0 * rng.rand()
        pcm = pcm_from_float(_tone(np, 16000, secs, 1, i), 16)
        name = f"audio/clip{i:02d}." + ("flac" if i % 4 == 3 else "wav")
        (write_flac if name.endswith("flac") else write_wav)(
            os.path.join(root, name), pcm, 16000)
        paths.append(name)
    classes = ["dog", "rain", "siren", "engine"]

    def dump(name, obj):
        with open(os.path.join(meta, name), "w") as f:
            json.dump(obj, f) if not isinstance(obj, str) else f.write(obj)

    dump("audioset_train.json", [{"uniq_id": i, "audio_path": p,
                                  "labels": [i % 4] + ([(i + 1) % 4] if i % 3 == 0 else [])}
                                 for i, p in enumerate(paths)])
    dump("audioset_class_labels_indices.csv", "index,mid,display_name\n" + "".join(
        f"{c},/m/{c},{n}\n" for c, n in enumerate(classes)))
    dump("esc50_fold-1.json", [{"uniq_id": i, "audio_path": paths[i],
                                "text": classes[i % 4], "class_label": i % 4}
                               for i in range(8)])
    dump("esc50_label.json", {str(c): [n] for c, n in enumerate(classes)})
    dump("audiocaps_test_new.tsv", "uniq_id\taudio\ttext\tduration\n" + "".join(
        f"{100 + i}\t{paths[8 + i]}\tthe sound of {classes[i % 4]} {i}\t5.0\n"
        for i in range(6)))
    dump("audiocaps_test_texts.json", {str(100 + i): [
        f"the sound of {classes[i % 4]} {i}", f"a recording of {classes[i % 4]}"]
        for i in range(6)})
    cfg = make_model_config(CLI_ARGS[CLI_ARGS.index("--model") + 1], "audio")
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    half = torch.float16
    sd = {"visual." + k: v for k, v in vision_tower_state_dict(cfg.tower, g, half).items()}
    sd.update({"image." + k: v for k, v in vision_tower_state_dict(
        image_tower_config(cfg), g, half).items()})
    sd.update(text_tower_state_dict(cfg.text, cfg.embed_dim, g, half))
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    pre = os.path.join(root, "vitlensL_audio_tri.pt")
    torch.save({k: v.cpu() for k, v in sd.items()}, pre)
    env = dict(os.environ, VITLENS_AUDIO_DATA_DIR=root,
               VITLENS_METADATA_DIR=os.path.join(root, "meta"))
    return env, pre


def _cli(env, argv, log, timeout=900):
    """python -m vitlens_tpu_torch.cli.train ``argv`` as a child process on
    the card, its output into ``log``; -> (exit code, seconds, stdout)."""
    cmd = [sys.executable, "-m", "vitlens_tpu_torch.cli.train", *argv]
    t0 = time.time()
    with open(log, "w") as err:
        p = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                           env=env, stdout=subprocess.PIPE, stderr=err,
                           text=True, timeout=timeout)
    return p.returncode, time.time() - t0, p.stdout


def _records(run_dir):
    with open(os.path.join(run_dir, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def _tree(path):
    import torch

    return torch.load(os.path.join(path, "tree.pt"), map_location="cpu",
                      weights_only=True)


def train_cli_phase(torch, np, counters, totals, card):
    """Phase 4x: the published vitlensL audio recipe through ``python -m
    vitlens_tpu_torch.cli.train`` on the card at full ViT-L-14 width and
    depth, from audio files (see write_cli_inputs); run (a) trains 2 epochs
    with zero-shot eval (ESC50 accuracy, AudioCaps recall) at each end and
    writes epoch_1, epoch_2, epoch_latest and checkpoint_best; run (b)
    resumes from --resume latest into epoch 3; run (c) prints
    --visual-stat-flops. In this process, through cli.train's functions: the
    AdamW moments loaded from epoch_2 bit-equal to the file's, one train step
    and one eval batch with their launches, and checkpoint_best's eval
    features against the same weights in fp32 on the CPU. Returns what
    phase 5 prints."""
    import tempfile

    from vitlens_tpu_torch.cli import train as T
    from vitlens_tpu_torch.cli.args import parse_args
    from vitlens_tpu_torch.data.loader import DevicePrefetcher
    from vitlens_tpu_torch.models import tri
    from vitlens_tpu_torch.train import checkpoint as C

    t0 = time.time()
    torch.cuda.empty_cache()  # the children allocate on the same card
    root = tempfile.mkdtemp(prefix="vitlens_4x_")
    env, pre = write_cli_inputs(torch, np, root)
    t_files = time.time() - t0
    logs = os.path.join(root, "logs")
    argv = [*CLI_ARGS, "--pretrained", pre, "--logs", logs, "--name", "a"]
    run, ckpts = os.path.join(logs, "a"), os.path.join(logs, "a", "checkpoints")

    # -- run (a): 2 epochs ------------------------------------------------------
    rc, t_a, _ = _cli(env, argv + ["--epochs", str(CLI_EPOCHS)],
                      os.path.join(root, "run_a.log"))
    if rc != 0:
        fail(f"4x run (a): exit {rc}: {open(os.path.join(root, 'run_a.log')).read()[-2000:]}")
    recs = _records(run)
    train = [r for r in recs if "train/loss" in r]
    val = [r for r in recs if "val/primary" in r]
    steps_a = len(train)
    per_epoch = CLI_CLIPS // 8
    if [r["step"] for r in train] != list(range(1, per_epoch * CLI_EPOCHS + 1)):
        fail(f"4x run (a): train steps {[r['step'] for r in train]}")
    bad = [r for r in train if not (np.isfinite(r["train/loss"])
                                    and r["train/grad_norm"] > 0)]
    if bad:
        fail(f"4x run (a): steps without a finite loss and a gradient: {bad}")
    want_keys = ("val/esc50@fold-1/accuracy", "val/audiocaps@test/r_mean",
                 "val/primary")
    if len(val) != CLI_EPOCHS or not all(k in r for r in val for k in want_keys):
        fail(f"4x run (a): val lines {val}")
    names = sorted(os.listdir(ckpts))
    for n in ("epoch_1", "epoch_2", "epoch_latest", "checkpoint_best", "best.json"):
        if n not in names:
            fail(f"4x run (a): {n} missing from {names}")
    ep2 = _tree(os.path.join(ckpts, "epoch_2"))

    # -- run (b): --resume latest into epoch 3 ------------------------------------
    rc, t_b, _ = _cli(env, argv + ["--epochs", str(CLI_EPOCHS + 1), "--resume",
                                   "latest"], os.path.join(root, "run_b.log"))
    out_log = open(os.path.join(run, "out.log")).read()
    if rc != 0 or f"(epoch {CLI_EPOCHS})" not in out_log:
        fail(f"4x run (b): exit {rc}: {open(os.path.join(root, 'run_b.log')).read()[-2000:]}")
    resumed = [r for r in _records(run) if "train/loss" in r][steps_a:]
    if ([r["step"] for r in resumed] != list(range(steps_a + 1, steps_a + per_epoch + 1))
            or any(r["train/epoch"] != CLI_EPOCHS for r in resumed)
            or not all(np.isfinite(r["train/loss"]) for r in resumed)):
        fail(f"4x run (b): resumed steps {resumed}")
    ep3 = _tree(os.path.join(ckpts, f"epoch_{CLI_EPOCHS + 1}"))
    if ep3["step"] != ep2["step"] + per_epoch:
        fail(f"4x run (b): step {ep3['step']} after epoch 3, epoch 2 ended at {ep2['step']}")

    # -- in this process, through cli.train's functions ---------------------------
    args = parse_args(argv + ["--epochs", str(CLI_EPOCHS + 1), "--device", "cuda"])
    os.environ.update({k: env[k] for k in ("VITLENS_AUDIO_DATA_DIR",
                                           "VITLENS_METADATA_DIR")})
    cfg, tok, model, mask = T.build_model(args, "cuda")
    info = T.build_train_data(args, tok, 1, cfg)
    step, ts = T.build_step(args, model, cfg, mask, info.num_batches * args.epochs)
    # frozen: the pretrained file's weights after the bf16 cast, untouched by
    # runs (a) and (b); trainable: moved by run (b)
    frozen_moved = [n for n, p in model.named_parameters()
                    if not mask[n] and not torch.equal(p.cpu(), ep3["params"][n])]
    unmoved = [n for n, p in model.named_parameters()
               if mask[n] and torch.equal(ep3["params"][n], ep2["params"][n])]
    if frozen_moved or unmoved:
        fail(f"4x: frozen tensors that differ from the pretrained file's "
             f"{frozen_moved[:5]}, trainable ones run (b) left {unmoved[:5]}")
    C.load_checkpoint(os.path.join(ckpts, "epoch_2"), ts)
    moments = [(m, n) for m in ("mu", "nu") for n, t in ts.opt_state[m].items()
               if not torch.equal(t.cpu(), ep2["opt_state"][m][n])]
    if (moments or ts.step != ep2["step"]
            or ts.opt_state["count"] != ep2["opt_state"]["count"]):
        fail(f"4x: AdamW state loaded from epoch_2 differs from the file's: "
             f"{moments[:5]}, step {ts.step} vs {ep2['step']}")
    n_moments = sum(t.numel() for t in ts.opt_state["mu"].values())
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    raw = next(iter(info.dataloader))
    batch = next(iter(DevicePrefetcher(
        [raw], device="cuda", map_fn=lambda r: T._prep_batch(r, args, tok))))
    if not (batch["visual"].is_cuda and batch["text"].is_cuda):
        fail("4x: the prefetcher handed out host tensors")
    _, counts = run_counted(torch, counters, totals,
                            lambda: step(ts, batch, fps_generator=gen))
    want = train_launches(cfg.tower, cfg.text.layers, args.accum_freq, False, False)
    if counts != want:
        fail(f"4x train step: launches {counts}, expected {want}")
    step_s = []
    for _ in range(3):
        t1 = time.perf_counter()
        _, m = step(ts, batch, fps_generator=gen)
        float(m["loss"])
        step_s.append(time.perf_counter() - t1)
    # one ESC50 eval batch (8 clips x 3) and checkpoint_best's features
    enc_visual, _ = T.eval_encoders(args, model)
    esc = T._build_real_dataset(args, "esc50@fold-1", train=False, cfg=cfg)
    x = np.stack([esc[i]["audio"] for i in range(8)])
    C.load_checkpoint(os.path.join(ckpts, "checkpoint_best"), ts, ckpt_only=True)
    flat = x.reshape((-1,) + x.shape[2:])
    feats, ecounts = run_counted(torch, counters, totals, lambda: enc_visual(flat))
    if ecounts != tower_launches(cfg.tower):
        fail(f"4x eval batch: launches {ecounts}, expected {tower_launches(cfg.tower)}")
    # the CPU fp32 copy on one sample's 3 clips (ViT-L in fp32 on the host)
    ref = copy.deepcopy(model.visual).to(device="cpu", dtype=torch.float32)
    with torch.no_grad():
        want_feats = ref(torch.from_numpy(flat[:3]), torch.float32)
    del ref
    ecos = cos_min(torch, torch.from_numpy(feats[:3]), want_feats)
    if not (np.isfinite(feats).all() and ecos >= COS_MIN):
        fail(f"4x: checkpoint_best's eval features vs CPU fp32: cosine {ecos}")
    # the host pipeline a clip: decode, mixup, fbank, SpecAugment
    ds = info.dataloader.dataset
    clip_ms = []
    for i in range(8):
        t1 = time.perf_counter()
        ds[i]
        clip_ms.append((time.perf_counter() - t1) * 1e3)
    del model, ts, step, batch

    # -- run (c): --visual-stat-flops ---------------------------------------------
    rc, t_c, out = _cli(env, [*CLI_ARGS[:4], "--visual-stat-flops", "--logs",
                              logs, "--name", "f"],
                        os.path.join(root, "run_c.log"))
    try:
        flops = json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        flops = None
    if rc != 0 or not flops or not flops["params_M"] > 0 or not flops[
            "gflops_per_sample"] > 0:
        fail(f"4x run (c): exit {rc}, stdout {out[-500:]!r}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4x train CLI] {card} | python -m vitlens_tpu_torch.cli.train "
          f"{' '.join(CLI_ARGS)} --pretrained <reference-layout vitlensL tri "
          f"file, fp16> on {CLI_CLIPS} AudioSet-style clips (6 FLAC) with ESC50 "
          f"(8 clips) and AudioCaps (6 rows) val: run (a) {CLI_EPOCHS} epochs, "
          f"{steps_a} steps, exit 0 in {t_a:.1f} s, losses "
          f"{[round(r['train/loss'], 4) for r in train]}, grad_norm "
          f"{[round(r['train/grad_norm'], 4) for r in train]}, val "
          + "; ".join(f"epoch {i + 1}: accuracy {r[want_keys[0]]:.4f} r_mean "
                      f"{r[want_keys[1]]:.4f} primary {r[want_keys[2]]:.4f}"
                      for i, r in enumerate(val))
          + f"; checkpoints {names}; run (b) --resume latest: epoch "
          f"{CLI_EPOCHS} steps {[r['step'] for r in resumed]}, exit 0 in "
          f"{t_b:.1f} s; frozen tensors bit-identical to the pretrained file's "
          f"after the bf16 cast, every trainable one moved by run (b); AdamW "
          f"moments ({n_moments} elements each) loaded from epoch_2 bit-equal "
          f"to the file's; in-process B = 8 accum_freq 2 step launches "
          f"{dict((k, v) for k, v in counts.items() if v)}, eval batch (8 x 3 "
          f"clips) {dict((k, v) for k, v in ecounts.items() if v)}; "
          f"checkpoint_best eval features vs CPU fp32 min cosine {ecos:.6f}; "
          f"run (c) --visual-stat-flops {flops} in {t_c:.1f} s; files written "
          f"in {t_files:.1f} s; phase took {time.time() - t0:.1f} s", flush=True)
    return {"step_s": step_s, "clip_ms": clip_ms, "flops": flops}


def train_cli_timings(card, ctx):
    """Phase 5's lines of phase 4x: the host-timed seconds of the B = 8
    accum_freq 2 train step of the recipe through cli.train's step, and the
    host ms a clip of the AudioSet train pipeline (decode, mixup, fbank,
    SpecAugment), one thread."""
    s = ctx["step_s"]
    print(f"[5 timing] {card} | train CLI step (vitlensL audio recipe, B = 8 "
          f"accum_freq 2, bf16; batch on the card): {min(s):.4f} s best of "
          f"{len(s)}, all {[round(x, 4) for x in s]}; host AudioSet train "
          f"pipeline a clip (decode, mixup, fbank, SpecAugment): "
          f"{min(ctx['clip_ms']):.2f} ms best, all "
          f"{[round(x, 2) for x in ctx['clip_ms']]}", flush=True)


def host_library_timings(torch, np, card, ctx):
    """Phase 5's native host library lines: PointCloudProcessor (8192
    points) on raw .npy clouds of 9000 and 10000 points with FPS through the
    library beside the plain numpy loop; a 10 s FLAC decoded by the library
    beside the pure-Python decoder; and a closed served loop of FLAC
    requests (64 requests of one 5 s FLAC from 16 client threads)."""
    import tempfile
    import threading

    from tools.reference_layout import pcm_from_float, write_flac
    from vitlens_tpu_torch.data import processors as P
    from vitlens_tpu_torch.data.audio_decode import decode_flac, load_audio_file
    from vitlens_tpu_torch.serve import make_server

    def best_ms(fn, runs):
        fn()
        times = []
        for _ in range(runs):
            t1 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t1) * 1e3)
        return min(times)

    files, root = ctx["files"], tempfile.mkdtemp(prefix="vitlens_5h_")
    rng = np.random.RandomState(SEED + 21)
    cloud10k = os.path.join(root, "cloud10k.npy")
    np.save(cloud10k, (rng.randn(10000, 3) * 0.3).astype(np.float32))
    proc = P.PointCloudProcessor(n_sample_points=8192)
    for label, path in (("9000", files["npy0"]), ("10000", cloud10k)):
        pc = np.load(path)
        nat = best_ms(lambda: proc([path]), 5)
        plain = best_ms(lambda: P.farthest_point_sample_plain(pc, 8192), 1)
        same = np.array_equal(P.farthest_point_sample_np(pc, 8192),
                              P.farthest_point_sample_plain(pc, 8192))
        print(f"[5 timing] {card} | host PointCloudProcessor, one .npy cloud of "
              f"{label} points -> [1, 8192, 3] (FPS through the native "
              f"library): {nat:.2f} ms best of 5; the plain numpy FPS loop "
              f"alone on the same cloud: {plain:.2f} ms; same points: {same}",
              flush=True)
    flac10 = os.path.join(root, "ten.flac")
    write_flac(flac10, pcm_from_float(_tone(np, 16000, 10.0, 1, 3), 16), 16000)
    nat = best_ms(lambda: load_audio_file(flac10), 5)
    py = best_ms(lambda: decode_flac(flac10), 1)
    if not np.array_equal(load_audio_file(flac10)[0], decode_flac(flac10)[0]):
        fail("5: the native FLAC decode differs from the pure-Python one")
    print(f"[5 timing] {card} | FLAC decode of a 10 s 16 kHz mono file: native "
          f"library {nat:.3f} ms best of 5, pure-Python decoder {py:.1f} ms "
          f"(bit-equal)", flush=True)
    flac5 = os.path.join(root, "five.flac")
    write_flac(flac5, pcm_from_float(_tone(np, 16000, 5.0, 1, 4), 16), 16000)
    srv, th = _serve(make_server, ctx["model"], B, 50)
    port = srv.server_address[1]
    _post(port, {"inputs": {"audio": [flac5]}})
    errors = []

    def client():
        for _ in range(4):
            try:
                _post(port, {"inputs": {"audio": [flac5]}})
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    clients = [threading.Thread(target=client) for _ in range(16)]
    t1 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(600)
    wall = time.perf_counter() - t1
    health = _healthz(port)
    _stop(srv, th)
    shutil.rmtree(root, ignore_errors=True)
    if errors:
        fail(f"FLAC served run: {len(errors)} requests failed: {errors[0]!r}")
    lat = health["latency"]
    print(f"[5 timing] {card} | served closed loop, FLAC: 64 audio requests "
          f"(one 5 s 16 kHz FLAC each, decoded by the native library) from 16 "
          f"client threads, max_batch {B}, max_wait 50 ms: {64 / wall:.2f} "
          f"requests/s ({wall:.2f} s), latency p50 {lat['p50_ms']} ms, p95 "
          f"{lat['p95_ms']} ms (/healthz, the warm request included)", flush=True)


# -- phase 4dp: data parallelism (ROADMAP Queue 1 item 12a) ----------------------

DP_REL = 1e-6        # (a) the world-1 NCCL step against the mesh=None step
DP_LOSS_REL = 1e-3   # (b) two B32 ranks against one B64 step: bf16, other shapes
# (b) gradient cosine a trainable group of the audio step against the B64
# step with accum_freq 2: its two passes run the towers at the ranks' B32
# shapes, so the bf16 roundings are the ranks' and what differs is the
# data-parallel arithmetic. Against the plain B64 step the bf16 products
# round at other shapes and in another order: a gradient that comes back
# through the 24 frozen bf16 trunk blocks (the class embedding's, the pc
# tokenizer's and Lens's) reads a cosine near 0.998 there, one process
# against one process. So against the plain B64 step each group is held
# to COS_MIN and to that one-process noise floor less DP_FLOOR_SLACK: the
# plain B64 step against its accum_freq 2 twin (the same function at the
# ranks' shapes) where the model has no BatchNorm; with BatchNorm the twin
# normalises over 32 rows, another function, and the floor is the B64
# step against itself on the batch with its halves swapped.
DP_COS_MIN = 0.999
DP_FLOOR_SLACK = 2e-3
# (b) grad_norm after the ranks' average against the B64 step's: summed
# rather than averaged gradients read a factor of world here, which no
# cosine sees; and each BatchNorm running statistic against the B64 step's:
# BatchNorm left unsynced updates them from a rank's 32 rows.
DP_NORM_REL = 1e-2
DP_BN_REL = 1e-4
DP_ENCODE_COS = 0.9999  # (c) the mesh encode against one device, row for row
# The Lens tower's trunk depth of the earlier multi-rank paths cut for time
# (ROADMAP's rule past 1050 s): 4dp (b)'s audio and pc steps (so 4fs (b)
# and (c) too), 4tp (a)'s encodes and 4pp (c)'s whole-tower gradient; full
# width, 12 of ViT-L/14's 24 blocks. The LoRA paths keep all 24.
CUT_DEPTH = 12


def cut_arch():
    """ViT-L/14's trunk at CUT_DEPTH blocks (create_model's ``arch=``)."""
    from vitlens_tpu_torch.config import get_arch

    return dataclasses.replace(get_arch("ViT-L-14")["vision"], layers=CUT_DEPTH)


def cut_tower_(tower):
    """``tower``'s trunk cut to its first CUT_DEPTH blocks, its config too."""
    tower.trunk.blocks = tower.trunk.blocks[:CUT_DEPTH]
    tower.cfg = dataclasses.replace(tower.cfg, arch=dataclasses.replace(
        tower.cfg.arch, layers=CUT_DEPTH))
    return tower


def launch_counters():
    """{counter name: wrapper} of every kernel wrapper, in COUNTED's order."""
    from vitlens_tpu_torch.ops.flash_attention import flash_attention
    from vitlens_tpu_torch.ops.fps import fps_indices
    from vitlens_tpu_torch.ops.fused_ln_proj import fused_ln_proj
    from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_save_preact
    from vitlens_tpu_torch.ops.fused_mlp_chain import (fused_attnout_mlp,
                                                       fused_mlp_chunked)
    from vitlens_tpu_torch.ops.fused_point_encoder import fused_point_encoder
    from vitlens_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                   int8_matmul_dequant,
                                                   int8_quantize)
    from vitlens_tpu_torch.ops.row_gather import row_gather

    counters = dict(zip(COUNTED, (fused_mlp, fused_mlp_save_preact,
                                  flash_attention, fps_indices,
                                  fused_point_encoder, fused_ln_proj,
                                  int8_matmul, int8_matmul_dequant,
                                  int8_quantize, row_gather, fused_mlp_chunked,
                                  fused_attnout_mlp)))
    if len(counters) != len(COUNTED):
        fail("a launch counter is missing")
    return counters


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def grabbed_step(torch, tx, step, *args, split=None, **kw):
    """step(*args, **kw) with the gradients AdamW was given (after the
    ranks' average; an FSDP shard gathered whole, and a TP slice of a block
    in ``split``, parallel.tp.split_params, gathered whole in JAX's layout)
    copied out: (step's output, {name: gradient})."""
    from vitlens_tpu_torch.parallel.fsdp import full_tensor
    from vitlens_tpu_torch.parallel.tp import gather_whole

    grads = {}
    update = tx.update_
    split = split or {}

    def grabbing(params, g, st, **ukw):
        grads.update({n: (gather_whole(n, t, split[n]) if n in split else
                          full_tensor(t)).detach().float().clone()
                      for n, t in g.items()})
        return update(params, g, st, **ukw)

    tx.update_ = grabbing
    try:
        return step(*args, **kw), grads
    finally:
        del tx.update_


def grad_groups(names):
    """Trainable tensors grouped by their first two name components; LoRA
    factors (``<tower>.lora.trunk.blocks.<i>.<target>.<a|b>``) by tower,
    target and factor, the block left out."""
    groups = {}
    for n in names:
        parts = n.split(".")
        key = (".".join(parts[:2] + parts[5:]) if parts[1:2] == ["lora"]
               else ".".join(parts[:2]))
        groups.setdefault(key, []).append(n)
    return groups


def group_cosines(torch, a, b, names):
    out = {}
    for g, ns in grad_groups(names).items():
        x = torch.cat([a[n].double().flatten() for n in ns])
        y = torch.cat([b[n].double().flatten() for n in ns])
        out[g] = (x @ y / (x.norm() * y.norm()).clamp_min(1e-300)).item()
    return out


def dp_nccl_phase(torch, np, counters, totals, model, state, tx, mask, sc,
                  batch_fn):
    """Phase 4dp (a): a world-size-1 NCCL group on a localhost TCP store, and
    the audio train step (phase 4b's model, at B64) through
    make_train_step(mesh=make_mesh()) against the mesh=None step from the
    same state and batch: loss, grad_norm, every gradient and every updated
    trainable parameter within DP_REL relative (the collectives run: the
    feature gather and its reduce-scatter, the bucketed all-reduce);
    launches those of train_launches, the collectives adding none of ours.
    Then phase 4fs (a): the same step with partition="fsdp" on the state
    placed by fsdp_place over the same group (FSDP2's all-gathers and
    reduce-scatters over one rank), held to the same bar and launches. The
    placement is in place and for good: the model is spent after it."""
    import datetime

    import torch.distributed as dist

    from vitlens_tpu_torch.parallel import fsdp as F
    from vitlens_tpu_torch.parallel import mesh as PM
    from vitlens_tpu_torch.train.step import make_train_step

    t0 = time.time()
    cfg = model.cfg
    names = [n for n, t in mask.items() if t]
    params = dict(model.named_parameters())
    snap = ({n: params[n].detach().clone() for n in names},
            {k: {n: t.clone() for n, t in state.opt_state[k].items()}
             for k in ("mu", "nu")}, state.opt_state["count"], state.step)
    bt = {k: v.cuda() for k, v in batch_fn(B).items()}
    want = train_launches(cfg.tower, cfg.text.layers, 1, False, False)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=120))
    runs = {}
    try:
        if PM.init_distributed(device="cuda:0") != 0:
            fail("4dp (a): init_distributed did not no-op in the group")
        mesh = PM.make_mesh()
        if (mesh.data, mesh.rank, mesh.backend, str(mesh.device)) != (
                1, 0, "nccl", "cuda:0"):
            fail(f"4dp (a): mesh {mesh}")
        for label, m, part in (("mesh=None", None, "ddp"),
                               ("world-1 NCCL", mesh, "ddp"),
                               ("world-1 NCCL FSDP", mesh, "fsdp")):
            with torch.no_grad():
                for n in names:
                    params[n].copy_(snap[0][n])
                for k in ("mu", "nu"):
                    for n, t in snap[1][k].items():
                        state.opt_state[k][n].copy_(t)
            state.opt_state["count"], state.step = snap[2], snap[3]
            step = make_train_step(cfg, tx, mask, sc, mesh=m, partition=part)
            t_run = time.time()
            if part == "fsdp":
                F.fsdp_place(state, mesh)
                placed = sum(a is not None for a in
                             F.placements_of(state)["params"].values())
            ((_, met), grads), counts = run_counted(
                torch, counters, totals,
                lambda: grabbed_step(torch, tx, step, state, bt))
            if counts != want:
                fail(f"4{'fs' if part == 'fsdp' else 'dp'} (a) {label}: "
                     f"launches {counts}, expected {want}")
            now = dict(model.named_parameters())
            runs[label] = ({k: float(v) for k, v in met.items()}, grads,
                           {n: F.full_tensor(now[n]).detach().float().clone()
                            for n in names}, time.time() - t_run)
    finally:
        dist.destroy_process_group()
    (m0, g0, p0, _), (m1, g1, p1, _) = runs["mesh=None"], runs["world-1 NCCL"]
    d = {"loss": abs(m1["loss"] / m0["loss"] - 1),
         "grad_norm": abs(m1["grad_norm"] / m0["grad_norm"] - 1),
         "gradients": max(rel_err(g1[n], g0[n]) for n in names),
         "parameters": max(rel_err(p1[n], p0[n]) for n in names)}
    if max(d.values()) > DP_REL:
        fail(f"4dp (a) world-1 NCCL step vs mesh=None: relative differences {d}")
    print(f"[4dp (a) NCCL world 1] vitlensL audio+text train step B{B} through "
          f"make_train_step(mesh=make_mesh()) on a world-size-1 NCCL group vs "
          f"mesh=None from the same state and batch: loss {m1['loss']:.6f} vs "
          f"{m0['loss']:.6f}, grad_norm {m1['grad_norm']:.6f} vs "
          f"{m0['grad_norm']:.6f}; largest relative differences "
          + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
          + f" (bar {DP_REL}); launches {counts} each, as train_launches; "
          f"phase {time.time() - t0:.1f} s", flush=True)
    m2, g2, p2, fs_s = runs["world-1 NCCL FSDP"]
    d = {"loss": abs(m2["loss"] / m0["loss"] - 1),
         "grad_norm": abs(m2["grad_norm"] / m0["grad_norm"] - 1),
         "gradients": max(rel_err(g2[n], g0[n]) for n in names),
         "parameters": max(rel_err(p2[n], p0[n]) for n in names)}
    same = [n for n in names if torch.equal(g2[n], g0[n])
            and torch.equal(p2[n], p0[n])]
    if max(d.values()) > DP_REL:
        fail(f"4fs (a) world-1 NCCL FSDP step vs mesh=None: relative "
             f"differences {d}")
    print(f"[4fs (a) NCCL world 1, FSDP] {card_line()} | vitlensL audio+text "
          f"train step B{B}, make_train_step(partition='fsdp') after "
          f"fsdp_place ({placed} of {len(now)} parameters sharded over the one "
          f"rank) vs mesh=None from the same state and batch: loss "
          f"{m2['loss']:.6f} vs {m0['loss']:.6f}, grad_norm "
          f"{m2['grad_norm']:.6f} vs {m0['grad_norm']:.6f}; largest relative "
          "differences " + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
          + f" (bar {DP_REL}); {len(same)} of {len(names)} trained tensors "
          f"bit-equal in gradient and update; launches {counts}, as "
          f"train_launches; {fs_s:.1f} s", flush=True)
    return fs_s


def dp_rank_recipe(torch, np, counters, mesh, modality, ckpt_root=None):
    """One rank of phase 4dp (b): the vitlensL ``modality`` recipe's DP step
    at B32 (this rank's half of a seeded B64 batch; the pc tri step with
    synced BatchNorm and pinned FPS starts; "lora": the audio step of phase
    4l's recipe, attach_lora_'s factors alone trained), then on rank 0 the
    mesh=None step at B64 on the whole batch from the same initial state;
    then phase 4fs (b) on every rank, the FSDP step from that state on the
    same rows (fs_rank_step; with ``ckpt_root``, 4fs (c)'s collective
    checkpoint). Returns what the parent prints and checks."""
    from vitlens_tpu_torch.factory import create_model, make_trainable_
    from vitlens_tpu_torch.train.freeze import tri_model_mask
    from vitlens_tpu_torch.train.step import (OptimizerConfig, StepConfig,
                                              init_train_state, make_optimizer,
                                              make_train_step)

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()  # 4dp (b)'s peak: this recipe's
    start_gb = torch.cuda.memory_allocated() / 1e9  # what it starts with
    lora = modality == "lora"
    model = create_model("ViT-L-14", "audio" if lora else modality, seed=SEED,
                         device="cuda", dtype=torch.float32,
                         **({} if lora else {"arch": cut_arch()}))
    cfg = model.cfg
    rng = np.random.RandomState(SEED)  # the same B64 batch on every rank
    starts = None
    if modality in ("audio", "lora"):
        flags = dict(lock_visual=True, lock_text=True, unlock_cls=not lora)
        sc = StepConfig(n_tower=2, align_to="text", compute_dtype=torch.bfloat16)
        text = rng.randint(1, 49000, size=(B, 77))
        text[:, 0], text[:, -1] = 49406, 49407
        a = cfg.tower.audio
        fb = rng.randn(B, a.target_length, a.mel_bins) * 0.5
        batch = {"text": torch.from_numpy(text).long(),
                 "visual": torch.from_numpy(fb.astype(np.float32))}
        want = train_launches(cfg.tower, cfg.text.layers, 1, False, False)
    else:
        flags = dict(lock_image=True, lock_text=True, lock_visual=True)
        sc = StepConfig(n_tower=3, sync_bn=True, compute_dtype=torch.bfloat16)
        batch = tri_batch(torch, np, cfg, B, rng)
        starts = torch.from_numpy(rng.randint(0, cfg.tower.point.npoints, B)
                                  .astype(np.int32))
        want = tri_train_launches(cfg, 1)
    mask = tri_model_mask(model, cfg, **flags)
    if lora:
        mask = attach_lora_(torch, model, mask)
    tx, mask = make_optimizer(model, OptimizerConfig(
        lr=1e-4, warmup=10, total_steps=1000, grad_clip_norm=1.0), mask)
    make_trainable_(model, mask, torch.bfloat16)
    names = [n for n, t in mask.items() if t]
    params = dict(model.named_parameters())
    init = {n: params[n].detach().clone() for n in names}
    bufs = {n: b for n, b in model.named_buffers() if n.endswith((".mean", ".var"))}
    bn0 = {n: b.clone() for n, b in bufs.items()}

    def run(bt, st, m, accum=1):
        state = init_train_state(model, tx)
        step = make_train_step(cfg, tx, mask, dataclasses.replace(
            sc, accum_freq=accum), mesh=m)
        bt = {k: v.cuda() for k, v in bt.items()}
        st = None if st is None else list(st.cuda().chunk(accum))
        torch.cuda.synchronize()
        t = time.time()
        ((_, met), grads), counts = run_counted(
            torch, counters, dict.fromkeys(counters, 0),
            lambda: grabbed_step(torch, tx, step, state, bt, fps_starts=st))
        return ({k: float(v) for k, v in met.items()}, grads, counts,
                time.time() - t)

    def reset():
        with torch.no_grad():
            for n in names:
                params[n].copy_(init[n])
            for n, b in bufs.items():
                b.copy_(bn0[n])

    r, half = mesh.rank, B // mesh.data
    local = {k: v[r * half:(r + 1) * half] for k, v in batch.items()}
    met, grads, counts, secs = run(
        local, None if starts is None else starts[r * half:(r + 1) * half], mesh)
    out = {"metrics": met, "launches": counts, "want": want, "step_s": secs,
           "ok_launches": counts == want}
    bn_dp = {n: b.clone() for n, b in bufs.items()}
    # on the host, out of the B64 steps' peak
    dp_after = {n: params[n].detach().float().cpu() for n in names}
    if r == 0:
        reset()
        met1, grads1, counts1, secs1 = run(batch, starts, None)
        bn_rel = {n: rel_err(bn_dp[n], bufs[n]) for n in bufs}
        reset()
        met2, grads2, counts2, _ = run(batch, starts, None, accum=2)
        swap = torch.cat([torch.arange(half, B), torch.arange(half)])
        reset()
        met3, grads3, counts3, _ = run({k: v[swap] for k, v in batch.items()},
                                       None if starts is None else starts[swap],
                                       None)
        out.update(
            single=met1, single_launches={k: counts1[k] + counts2[k] + counts3[k]
                                          for k in counts1},
            swapped=met3, cosines_floor=group_cosines(torch, grads3, grads1, names),
            single_s=secs1, accum2=met2,
            ok_single=counts1 == want == counts3 and counts2 == (
                tri_train_launches(cfg, 2) if modality == "pc" else
                train_launches(cfg.tower, cfg.text.layers, 2, False, False)),
            loss_rel=abs(met["loss"] / met1["loss"] - 1),
            grad_norm_rel=abs(met["grad_norm"] / met1["grad_norm"] - 1),
            cosines=group_cosines(torch, grads, grads2, names),
            cosines_b64=group_cosines(torch, grads, grads1, names),
            cosines_b64_accum2=group_cosines(torch, grads1, grads2, names),
            bn_rel=bn_rel)
        del grads1, grads2, grads3
    reset()
    dp = {"metrics": met, "grads": grads, "params": dp_after, "bn": bn_dp,
          "launches": counts}
    del params, init, bn0, grads
    out["dp_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["dp_start_gb"] = start_gb
    out["fsdp"] = fs_rank_step(torch, counters, mesh, model, tx, mask, sc,
                               local, starts, names, bufs, dp, flags, ckpt_root)
    out["_gathered"] = out["fsdp"].pop("_gathered", None)
    del model, bufs, dp
    # FSDP2's hooks keep the placed model in reference cycles: collect them,
    # or the next recipe starts with this one's state resident
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    return out


# -- phase 4fs: FSDP (ROADMAP Queue 1 item 12b) ------------------------------------

FS_REL = 1e-5  # (b) the FSDP step against the same ranks' DP step


def state_bytes(state):
    """{"params", "moments"}: the bytes of parameters and AdamW moments this
    rank stores (a shard's local bytes)."""
    from vitlens_tpu_torch.parallel.fsdp import local_tensor

    def nbytes(t):
        t = local_tensor(t)
        return t.numel() * t.element_size()

    return {"params": sum(nbytes(p) for p in state.model.parameters()),
            "moments": sum(nbytes(t) for m in ("mu", "nu")
                           for t in state.opt_state[m].values())}


def fs_rank_step(torch, counters, mesh, model, tx, mask, sc, local, starts,
                 names, bufs, dp, flags, ckpt_root=None):
    """Phase 4fs (b) on one rank: the FSDP step (fsdp_place, then
    make_train_step(partition="fsdp")) from the DP step's initial state on
    the same rows, the FPS starts the global batch's: loss and grad_norm,
    every gradient and updated parameter (gathered) against the DP step's
    ``dp``, each BatchNorm running statistic, the launches; the bytes of
    parameters and moments this rank stores beside the DP step's and the
    placements' count, and the step's peak memory. With ``ckpt_root``,
    phase 4fs (c): the collective save, the reload into the two ranks (bit
    for bit), and rank 0's gathered state for the unsharded load
    (fs_unsharded_load). The model is placed for good."""
    from vitlens_tpu_torch.parallel import fsdp as F
    from vitlens_tpu_torch.train import checkpoint as C
    from vitlens_tpu_torch.train.step import init_train_state, make_train_step

    def say(msg):  # the rank's log: where a crash happened
        print(f"rank {mesh.rank} {model.cfg.tower.modality} 4fs: {msg}",
              flush=True)

    t0 = time.time()
    # the LoRA recipe: every base weight bit-equal after the step, every
    # factor moved (kept on the host)
    lora = any(".lora." in n for n in names)
    before = ({n: p.detach().cpu().clone() for n, p in model.named_parameters()}
              if lora else None)
    state = init_train_state(model, tx)
    axes = F.param_axes(model, mesh.data)
    full = state_bytes(state)
    placed_bytes = sum(
        p.numel() // (mesh.data if axes[n] is not None else 1) * p.element_size()
        * (3 if n in state.opt_state["mu"] else 1)
        for n, p in model.named_parameters())
    step = make_train_step(model.cfg, tx, mask, sc, mesh=mesh, partition="fsdp")
    say("fsdp_place")
    F.fsdp_place(state, mesh)
    stored = state_bytes(state)
    say("the step")
    bt = {k: v.cuda() for k, v in local.items()}
    st = None if starts is None else [starts.cuda()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    ((_, met), grads), counts = run_counted(
        torch, counters, dict.fromkeys(counters, 0),
        lambda: grabbed_step(torch, tx, step, state, bt, fps_starts=st))
    step_s = time.time() - t
    peak = torch.cuda.max_memory_allocated() / 1e9
    now = dict(model.named_parameters())
    after = {n: F.full_tensor(now[n]).detach().float() for n in names}

    def err(a, b):  # of b's max|b|
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    out = {
        "metrics": {k: float(v) for k, v in met.items()},
        "loss_rel": abs(float(met["loss"]) / dp["metrics"]["loss"] - 1),
        "grad_norm_rel": abs(float(met["grad_norm"])
                             / dp["metrics"]["grad_norm"] - 1),
        "grad_err": max(err(grads[n], dp["grads"][n]) for n in names),
        "param_err": max(err(after[n], dp["params"][n].to(after[n].device))
                         for n in names),
        "bn_rel": {n: rel_err(b, dp["bn"][n]) for n, b in bufs.items()},
        "launches": counts, "ok_launches": counts == dp["launches"],
        "bytes": {"dp": full["params"] + full["moments"],
                  "fsdp": stored["params"] + stored["moments"],
                  "placements": placed_bytes},
        "sharded": sum(a is not None for a in axes.values()),
        "tensors": len(axes), "peak_gb": peak,
        "step_s": step_s}
    # grad_norm sums the shards' squares in another order than the DP
    # step's global norm; the parameters feel that only through the clip
    out["bit_equal"] = (out["loss_rel"] == 0
                        and all(torch.equal(grads[n], dp["grads"][n])
                                for n in names)
                        and all(torch.equal(after[n], dp["params"][n].to(
                            after[n].device)) for n in names))
    if lora:
        now = {n: F.full_tensor(p).detach().cpu() for n, p in
               model.named_parameters()}
        out["lora"] = {
            "factors": len([n for n in names if ".lora." in n]),
            "base_moved": [n for n in now if n not in names
                           and not torch.equal(now[n], before[n])],
            "factors_still": [n for n in names if ".lora." in n
                              and torch.equal(now[n], before[n])]}
        del now, before
    del grads, after
    say(f"step done: {out['metrics']}")
    if ckpt_root is not None:
        say("the collective save")
        t = time.time()
        path = C.save_checkpoint_sharded(ckpt_root, state, 1)
        out["save_s"] = time.time() - t
        keep = [F.local_tensor(p).detach().clone() for p in model.parameters()]
        keep += [F.local_tensor(x).clone() for k in ("mu", "nu")
                 for x in state.opt_state[k].values()]
        gathered = {
            "params": {n: F.full_tensor(p).detach().cpu()
                       for n, p in model.named_parameters()},
            "mu": {n: F.full_tensor(x).cpu()
                   for n, x in state.opt_state["mu"].items()},
            "nu": {n: F.full_tensor(x).cpu()
                   for n, x in state.opt_state["nu"].items()},
            "count": state.opt_state["count"], "step": state.step,
            "path": path, "flags": flags, "cfg": model.cfg}
        with torch.no_grad():
            live = [F.local_tensor(p) for p in model.parameters()]
            live += [F.local_tensor(x) for k in ("mu", "nu")
                     for x in state.opt_state[k].values()]
            for x in live:
                x.fill_(float("nan"))
        state.step = state.opt_state["count"] = 0
        say("the reload")
        t = time.time()
        C.load_checkpoint_sharded(path, state)
        torch.cuda.synchronize()
        out["load_s"] = time.time() - t
        out["reloaded"] = (all(torch.equal(a, b) for a, b in zip(live, keep))
                           and (state.step, state.opt_state["count"]) == (
                               gathered["step"], gathered["count"]))
        out["ckpt_gb"] = sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
        ) / 1e9 if mesh.rank == 0 else None
        if mesh.rank == 0:
            out["_gathered"] = gathered
        del keep, live
    del state, step
    out["seconds"] = time.time() - t0
    return out


def fs_unsharded_load(torch, gathered):
    """Phase 4fs (c) in one process (no process group): a fresh vitlensL
    state of the recipe, unplaced, loads the two ranks' collective
    checkpoint; every parameter and moment against the ranks' gathered
    state, bit for bit. Returns (equal, seconds)."""
    from vitlens_tpu_torch.factory import make_trainable_
    from vitlens_tpu_torch.models.tri import TriModel
    from vitlens_tpu_torch.train import checkpoint as C
    from vitlens_tpu_torch.train.freeze import tri_model_mask
    from vitlens_tpu_torch.train.step import (OptimizerConfig, init_train_state,
                                              make_optimizer)

    t0 = time.time()
    cfg = gathered["cfg"]
    model = TriModel(cfg, device="cuda")  # every value comes from the load
    mask = tri_model_mask(model, cfg, **gathered["flags"])
    tx, mask = make_optimizer(model, OptimizerConfig(), mask)
    make_trainable_(model, mask, torch.bfloat16)
    state = init_train_state(model, tx)
    C.load_checkpoint_sharded(gathered["path"], state)
    equal = all(torch.equal(p.detach().cpu(), gathered["params"][n])
                for n, p in model.named_parameters())
    for k in ("mu", "nu"):
        equal = equal and sorted(state.opt_state[k]) == sorted(gathered[k]) and all(
            torch.equal(x.cpu(), gathered[k][n])
            for n, x in state.opt_state[k].items())
    equal = equal and (state.step, state.opt_state["count"]) == (
        gathered["step"], gathered["count"])
    del model, state
    torch.cuda.empty_cache()
    return equal, time.time() - t0


DP_RECIPES = ("audio", "pc", "lora")  # 4dp (b) / 4fs (b)'s, in this order


def recipe_line(modality):
    """What a 4dp (b) / 4fs (b) line calls the recipe."""
    return {"audio": (f"audio+text step (phase 4b's recipe; the Lens trunk "
                      f"cut to {CUT_DEPTH} blocks)"),
            "pc": (f"pc tri step, synced BatchNorm, pinned FPS starts (the "
                   f"Lens trunk cut to {CUT_DEPTH} blocks)"),
            "lora": (f"audio+text LoRA step (phase 4l's recipe: rank "
                     f"{LORA_RANK} on the four targets of the audio trunk, "
                     f"the b's drawn N(0, {LORA_B_STD}), the factors and the "
                     "logit scale alone trained)")}[modality]


def dp_rank_main(out_dir, recipes=DP_RECIPES) -> int:
    """A rank process of phase 4dp (b), started by dp_ranks_phase with
    torchrun's variables: a gloo group sharing the card with the other
    rank (the phase sets it up; init_distributed then no-ops), the audio,
    the pc and the LoRA recipe (dp_rank_recipe; ``recipes``: those to run),
    results to rank{r}.json. A crash prints the Python stack (faulthandler)
    into the rank's log."""
    import datetime
    import faulthandler

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vitlens_tpu_torch.parallel import mesh as PM

    faulthandler.enable()
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=300))
    if PM.init_distributed(device="cuda:0") != rank:
        fail("init_distributed did not no-op in the gloo group")
    mesh = PM.make_mesh(device="cuda:0")
    if (mesh.data, mesh.rank, mesh.backend, str(mesh.device)) != (
            world, rank, "gloo", "cuda:0"):
        fail(f"mesh {mesh}")
    counters = launch_counters()
    res = {"rank": rank}
    gathered = None
    for modality in recipes:
        res[modality] = dp_rank_recipe(
            torch, np, counters, mesh, modality,
            os.path.join(out_dir, "ckpt") if modality == "audio" else None)
        gathered = res[modality].pop("_gathered") or gathered
        dist.barrier()
    # the DP recipes' peak (4fs (b) reads its own)
    res["peak_gb"] = max(res[m]["dp_peak_gb"] for m in recipes)
    dist.destroy_process_group()
    if rank == 0 and gathered is not None:  # 4fs (c): the checkpoint into
        res["unsharded"] = fs_unsharded_load(torch, gathered)  # one process
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def dp_ranks_phase(torch, totals, card, rank_argv=None, lora_only=False):
    """Phase 4dp (b): two rank processes sharing the card over gloo (NCCL
    refuses two ranks on one device), each running the audio step and the
    pc tri step with synced BatchNorm at B32 (dp_rank_recipe); rank 0 then
    runs the mesh=None B64 step on the whole batch. Their output goes to
    files; a rank that fails or outlives the join's limit fails the phase.
    Checks the loss (DP_LOSS_REL), the gradient cosine a trainable group
    (DP_COS_MIN and the one-process floor), grad_norm (DP_NORM_REL), each
    BatchNorm running statistic (DP_BN_REL), each rank's launches against
    train_launches and tri_train_launches; prints each rank's peak memory
    beside this process's. Then phase 4fs (b) and (c) from the same ranks
    (fs_rank_step, fs_unsharded_load): the FSDP step against each rank's
    DP step (FS_REL) and its launches, the collective checkpoint's round
    trips. The LoRA recipe takes the audio recipe's bars, and 4fs (b) also
    checks that its base weights stay bit-equal and its factors move.
    Returns 4fs's seconds in the ranks. ``rank_argv``: the command of a
    rank before its output directory (default: this script's
    ``--dp-rank``); ``lora_only``: the ranks run the LoRA recipe alone."""
    t0 = time.time()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    res = run_ranks("4dp (b)", 2, rank_argv or [
        sys.executable, os.path.abspath(__file__), "--dp-rank"]
        + (["--lora"] if lora_only else []))
    recipes = [m for m in DP_RECIPES if m in res[0]]
    for modality in recipes:
        for r in range(2):
            got = res[r][modality]
            if not got["ok_launches"]:
                fail(f"4dp (b) rank {r} {modality}: launches {got['launches']}, "
                     f"expected {got['want']}")
            for name, n in got["launches"].items():
                totals[name] += n
        r0 = res[0][modality]
        for name, n in r0["single_launches"].items():
            totals[name] += n
        cos, cos64 = r0["cosines"], r0["cosines_b64"]
        floor = r0["cosines_floor"] if r0["bn_rel"] else r0["cosines_b64_accum2"]
        if not r0["ok_single"]:
            fail(f"4dp (b) {modality}: the B64 steps' launches "
                 f"{r0['single_launches']}")
        below = [k for k, v in cos64.items()
                 if v < COS_MIN or v < floor[k] - DP_FLOOR_SLACK]
        bn_off = {k: v for k, v in r0["bn_rel"].items() if v > DP_BN_REL}
        if (r0["loss_rel"] > DP_LOSS_REL or below
                or (modality != "pc" and min(cos.values()) < DP_COS_MIN)
                or r0["grad_norm_rel"] > DP_NORM_REL or bn_off):
            fail(f"4dp (b) {modality}: two ranks vs the B64 step: loss "
                 f"{r0['metrics']['loss']} vs {r0['single']['loss']}, "
                 f"grad_norm {r0['metrics']['grad_norm']} vs "
                 f"{r0['single']['grad_norm']} (relative "
                 f"{r0['grad_norm_rel']:.3e}, bar {DP_NORM_REL}), BatchNorm "
                 f"statistics past {DP_BN_REL} relative {bn_off}, gradient "
                 f"cosines vs plain {cos64} (one-process floor {floor}), vs "
                 f"accum_freq 2 {cos}")
        if res[1][modality]["metrics"] != r0["metrics"]:
            fail(f"4dp (b) {modality}: the ranks' metrics differ: "
                 f"{r0['metrics']} vs {res[1][modality]['metrics']}")
        print(f"[4dp (b) two ranks, gloo] {card} | vitlensL {modality} "
              + recipe_line(modality)
              + f": 2 ranks x B{B // 2} vs one B{B} step: loss "
              f"{r0['metrics']['loss']:.6f} vs {r0['single']['loss']:.6f} "
              f"(relative {r0['loss_rel']:.3e}, bar {DP_LOSS_REL}), grad_norm "
              f"{r0['metrics']['grad_norm']:.6f} vs {r0['single']['grad_norm']:.6f}"
              f" (relative {r0['grad_norm_rel']:.3e}, bar {DP_NORM_REL}); "
              "gradient cosine a group "
              f"vs the plain B{B} step: "
              + ", ".join(f"{k} {v:.6f}" for k, v in cos64.items())
              + f" (bar {COS_MIN} and the floor less {DP_FLOOR_SLACK}, the "
              f"floor {'swapped halves' if r0['bn_rel'] else 'accum_freq 2'}); "
              f"the B{B} step on the batch with its halves swapped (loss "
              f"{r0['swapped']['loss']:.6f}) vs the plain one: "
              + ", ".join(f"{k} {v:.6f}" for k, v in
                          r0["cosines_floor"].items())
              + f"; vs the B{B} step with accum_freq 2 (loss "
              f"{r0['accum2']['loss']:.6f}" + (", the ranks' B32 shapes): "
                                               if modality != "pc" else
                                               ", BatchNorm over 32 rows): ")
              + ", ".join(f"{k} {v:.6f}" for k, v in cos.items())
              + (f" (bar {DP_COS_MIN})" if modality != "pc" else "")
              + f"; plain B{B} vs accum_freq 2, both one process: " + ", ".join(
                  f"{k} {v:.6f}" for k, v in r0["cosines_b64_accum2"].items())
              + (("; BatchNorm running statistics, DP vs B64, largest relative "
                  "difference " + ", ".join(f"{k.split('adapter.')[-1]} {v:.3e}"
                                            for k, v in r0["bn_rel"].items())
                  + f" (bar {DP_BN_REL})")
                 if r0["bn_rel"] else "")
              + f"; launches each rank {res[0][modality]['launches']} and "
              f"{res[1][modality]['launches']} (as expected), the three B{B} "
              f"steps {r0['single_launches']}; DP step {r0['step_s']:.3f} s and "
              f"{res[1][modality]['step_s']:.3f} s, B{B} step "
              f"{r0['single_s']:.3f} s (first calls, host-timed)", flush=True)
    total = resident + sum(r["peak_gb"] for r in res)
    each = "; ".join(
        f"rank {r}: " + ", ".join(
            f"{m} {res[r][m]['dp_peak_gb']:.2f} (from "
            f"{res[r][m]['dp_start_gb']:.2f})" for m in recipes)
        for r in range(2))
    print(f"[4dp (b) memory] {card} | peak GB rank 0 {res[0]['peak_gb']:.2f}, "
          f"rank 1 {res[1]['peak_gb']:.2f} (each recipe's, from what it "
          f"started with: {each}), this process resident "
          f"{resident:.2f}: {total:.2f} GB at most together; phase "
          f"{time.time() - t0:.1f} s", flush=True)
    return fs_check(res, totals, card)


def fs_check(res, totals, card):
    """Phase 4fs (b) and (c)'s checks and lines, from the rank files;
    returns the seconds 4fs took in the ranks (rank 0's)."""
    fs_s = 0.0
    for modality in [m for m in DP_RECIPES if m in res[0]]:
        fs = [res[r][modality]["fsdp"] for r in range(2)]
        for r, f in enumerate(fs):
            if not f["ok_launches"]:
                fail(f"4fs (b) rank {r} {modality}: launches {f['launches']}, "
                     f"the DP step's {res[r][modality]['launches']}")
            for name, n in f["launches"].items():
                totals[name] += n
            bn_off = {k: v for k, v in f["bn_rel"].items() if v > FS_REL}
            errs = {k: f[k] for k in ("loss_rel", "grad_norm_rel", "grad_err",
                                      "param_err")}
            if max(errs.values()) > FS_REL or bn_off:
                fail(f"4fs (b) rank {r} {modality}: the FSDP step vs the same "
                     f"ranks' DP step: {errs}, BatchNorm statistics past "
                     f"{FS_REL} relative {bn_off} (bar {FS_REL}); loss "
                     f"{f['metrics']['loss']} vs "
                     f"{res[r][modality]['metrics']['loss']}, grad_norm "
                     f"{f['metrics']['grad_norm']} vs "
                     f"{res[r][modality]['metrics']['grad_norm']}")
        if fs[1]["metrics"] != fs[0]["metrics"]:
            fail(f"4fs (b) {modality}: the ranks' metrics differ: "
                 f"{fs[0]['metrics']} vs {fs[1]['metrics']}")
        lora = [f["lora"] for f in fs if "lora" in f]
        if any(x["base_moved"] or x["factors_still"] for x in lora):
            fail(f"4fs (b) lora: base weights that changed "
                 f"{[x['base_moved'][:4] for x in lora]}, factors that did not "
                 f"{[x['factors_still'][:4] for x in lora]}")
        gb = [{k: v / 1e9 for k, v in f["bytes"].items()} for f in fs]
        print(f"[4fs (b) two ranks, gloo, FSDP] {card} | vitlensL {modality} "
              + recipe_line(modality)
              + f", B{B // 2} a rank, fsdp_place ({fs[0]['sharded']} of "
              f"{fs[0]['tensors']} parameters sharded) vs the same ranks' DP "
              f"step from the same state: loss {fs[0]['metrics']['loss']:.6f} "
              f"(relative {fs[0]['loss_rel']:.3e}), grad_norm "
              f"{fs[0]['metrics']['grad_norm']:.6f} ({fs[0]['grad_norm_rel']:.3e}),"
              f" gradients {max(f['grad_err'] for f in fs):.3e} and updated "
              f"parameters {max(f['param_err'] for f in fs):.3e} of max|DP|"
              + (", BatchNorm statistics " + ", ".join(
                  f"{k.split('adapter.')[-1]} {max(f['bn_rel'][k] for f in fs):.3e}"
                  for k in fs[0]["bn_rel"]) if fs[0]["bn_rel"] else "")
              + f" (bar {FS_REL}; loss, gradients and updated parameters "
              f"bit-equal to the DP step's on each rank: "
              f"{[f['bit_equal'] for f in fs]})"
              + (f"; {lora[0]['factors']} factor tensors, every base weight "
                 "bit-equal after the step and every factor moved on both "
                 "ranks" if lora else "")
              + f"; launches each rank {fs[0]['launches']} and "
              f"{fs[1]['launches']}, the DP step's; parameters + moments "
              f"stored GB rank 0 {gb[0]['fsdp']:.3f}, rank 1 {gb[1]['fsdp']:.3f} "
              f"(DP {gb[0]['dp']:.3f}, the placements' count "
              f"{gb[0]['placements']:.3f}); the FSDP step's peak GB rank 0 "
              f"{fs[0]['peak_gb']:.2f}, rank 1 {fs[1]['peak_gb']:.2f}; FSDP "
              f"step {fs[0]['step_s']:.3f} s and {fs[1]['step_s']:.3f} s (first "
              "calls, host-timed); the recipe (4dp (b) and 4fs (b)) "
              + ", ".join(f"{res[r][modality]['seconds']:.1f}" for r in range(2))
              + " s a rank", flush=True)
        fs_s += fs[0]["seconds"]
    if "unsharded" not in res[0]:
        return fs_s
    ck = [res[r]["audio"]["fsdp"] for r in range(2)]
    same, secs = res[0]["unsharded"]
    if not (ck[0]["reloaded"] and ck[1]["reloaded"] and same):
        fail(f"4fs (c): the collective checkpoint did not round-trip: reload "
             f"into the ranks {[c['reloaded'] for c in ck]}, into one process "
             f"unsharded {same}")
    print(f"[4fs (c) sharded checkpoint] {card} | the audio FSDP state after "
          f"(b): saved collectively by the two ranks in {ck[0]['save_s']:.2f} s "
          f"({ck[0]['ckpt_gb']:.3f} GB, DCP), reloaded into the two ranks "
          f"({ck[0]['load_s']:.2f} s) and into one process unsharded "
          f"({secs:.2f} s), both bit for bit against the saved state",
          flush=True)
    return fs_s + secs


def dp_encode_phase(torch, np, counters, totals, card):
    """Phase 4dp (c): ViTLens("vitlensL", ("audio", "text")) over a local mesh
    of the card twice (two chunks, one replica) against the same model
    without a mesh: B = 5 audio requests (three clips each, padded to 6 and
    split 3 + 3) and 3 captions, row for row (cosine >= DP_ENCODE_COS);
    launches twice a chunk's tower_launches. Then a served closed loop (32
    audio requests of one 5 s WAV from 8 client threads) on the model the
    serve CLI's --data-parallel 1 mesh builds."""
    import tempfile
    import threading

    from tools.reference_layout import pcm_from_float, write_wav
    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.cli import serve as S
    from vitlens_tpu_torch.parallel.mesh import make_mesh
    from vitlens_tpu_torch.serve import make_server

    t0 = time.time()
    kw = dict(compute_dtype=torch.bfloat16, seed=SEED)
    dp = ViTLens("vitlensL", ("audio", "text"),
                 mesh=make_mesh(devices=["cuda:0", "cuda:0"]), **kw)
    one = ViTLens("vitlensL", ("audio", "text"), device="cuda", **kw)
    acfg, n_text = one.towers["audio"].cfg, one.towers["text"].cfg.layers
    g = torch.Generator(device="cuda").manual_seed(SEED)
    fb5 = torch.randn(5, 3, acfg.audio.target_length, acfg.audio.mel_bins,
                      generator=g, device="cuda") * 0.5
    captions = ["a dog barking", "rain on a tin roof", "an engine starting"]
    rows = {}
    for m, x, per_chunk in (("audio", fb5, tower_launches(acfg)),
                            ("text", captions, launch_counts(fused_mlp=n_text))):
        pre = m == "audio"
        got, counts = run_counted(
            torch, counters, totals,
            lambda: dp.encode({m: x}, preprocessed=pre)[m])
        want = one.encode({m: x}, preprocessed=pre)[m]
        expect = {k: 2 * v for k, v in per_chunk.items()}
        if counts != expect:
            fail(f"4dp (c) {m}: launches {counts}, expected {expect}")
        rows[m] = (tuple(got.shape), cos_min(torch, got, want), abs_err(got, want))
        if got.shape != want.shape or rows[m][1] < DP_ENCODE_COS:
            fail(f"4dp (c) {m}: mesh encode vs one device {rows[m]}")
    del dp, one
    torch.cuda.empty_cache()
    args = S.build_parser().parse_args(["--data-parallel", "1"])
    served = ViTLens("vitlensL", ("audio",), mesh=S.data_parallel_mesh(
        args.data_parallel, args.device), **kw)
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_serve_")
    wav = os.path.join(root, "a.wav")
    write_wav(wav, pcm_from_float(_tone(np, 16000, 5.0, 1, 3), 16), 16000)
    srv, th = _serve(make_server, served, 32, 50)
    port = srv.server_address[1]
    _post(port, {"inputs": {"audio": [wav]}})  # warm the path
    errors = []

    def client():
        for _ in range(4):
            try:
                _post(port, {"inputs": {"audio": [wav]}})
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    clients = [threading.Thread(target=client) for _ in range(8)]
    t1 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(600)
    wall = time.perf_counter() - t1
    health = _healthz(port)
    _stop(srv, th)
    shutil.rmtree(root, ignore_errors=True)
    del served
    torch.cuda.empty_cache()
    if errors:
        fail(f"4dp (c) served run: {len(errors)} requests failed: {errors[0]!r}")
    lat = health["latency"]
    print(f"[4dp (c) mesh encode] {card} | ViTLens('vitlensL', ('audio', 'text'),"
          f" mesh=make_mesh(devices=['cuda:0', 'cuda:0'])) vs the same model on "
          f"one device, (shape, min cosine, max abs difference): "
          + ", ".join(f"{m} {v[0]} {v[1]:.7f} {v[2]:.3e}" for m, v in rows.items())
          + f" (bar {DP_ENCODE_COS}); launches twice a chunk's; served closed "
          f"loop with --data-parallel 1: 32 audio requests (one 5 s WAV) from 8 "
          f"client threads: {32 / wall:.2f} requests/s, p50 {lat['p50_ms']} ms, "
          f"p95 {lat['p95_ms']} ms; phase {time.time() - t0:.1f} s", flush=True)


# -- phase 4tp: the model axis (ROADMAP Queue 1 item 12c) -----------------------

TP_WORLD, TP_MODEL = 4, 2  # [data 2, model 2], four ranks sharing the card
TP_ENCODE_B = 8            # (a): the audio encode's requests (3 clips each)
TP_B = 32                  # (b): the step's global batch, B16 a data rank
TP_BIAS_STD = 0.02         # the trunk's out_b, drawn from SEED: MHA's init
                           # zeroes it, which would hide a bias added twice
TP_BYTES_SLACK = 0.01      # (b): a rank's trunk bytes within 1% of half
TP_MODES = ("sp", "tp", "tpsp")
TP_STEPS = {"tp": "bfloat16", "tpsp": "bfloat16", "tp32": "float32"}
TP_LORA_STEPS = {"tp": "bfloat16", "tp32": "float32"}  # (b)'s LoRA variant


def tp_groups(names):
    """Trainable tensors grouped by their path with the block and layer
    indices left out: each kind of trunk parameter (a block's ln_1.scale,
    its qkv_w, ...) is a group of its own, so that a fault in a small one
    (the LayerNorms) shows in its cosine."""
    groups = {}
    for n in names:
        key = ".".join("*" if p.isdigit() else p for p in n.split("."))
        groups.setdefault(key, []).append(n)
    return groups


def tp_cosines(torch, a, b, names):
    out = {}
    for g, ns in tp_groups(names).items():
        x = torch.cat([a[n].double().flatten().cpu() for n in ns])
        y = torch.cat([b[n].double().flatten().cpu() for n in ns])
        out[g] = (x @ y / (x.norm() * y.norm()).clamp_min(1e-300)).item()
    return out


def tp_biases_(torch, tower):
    """Give the trunk's out_b values from SEED (MHA's init leaves them 0)."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    with torch.no_grad():
        for block in tower.trunk.blocks:
            b = block.attn.out_b
            b.copy_(torch.randn(b.shape, generator=g) * TP_BIAS_STD)


def tp_encode(torch, np, counters, mesh):
    """Phase 4tp (a) on one rank: ViTLens("vitlensL", ("audio",)) in bf16
    (its trunk cut to CUT_DEPTH blocks),
    B8 requests of 3 clips, on the one process (the whole trunk), under SP
    alone (the same weights), then split over the model axis (TP), and
    under TP + SP; each data row of the mesh is a [data 1, model 2] pair
    encoding the same batch. The cosine of each against the one-process
    encode, the launches of each encode, and its host-timed ms (the second
    of two calls)."""
    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.parallel.sp import sequence_sharded_activations
    from vitlens_tpu_torch.parallel.tp import shard_vision_tower

    one = ViTLens("vitlensL", ("audio",), device="cuda",
                  compute_dtype=torch.bfloat16, seed=SEED)
    tower = cut_tower_(one.towers["audio"])
    acfg, dev = tower.cfg, next(tower.parameters()).device
    tp_biases_(torch, tower)
    g = torch.Generator(device=dev).manual_seed(SEED)
    fb = torch.randn(TP_ENCODE_B, 3, acfg.audio.target_length,
                     acfg.audio.mel_bins, generator=g, device=dev) * 0.5

    def encode():
        return one.encode({"audio": fb}, preprocessed=True)["audio"]

    def timed(ctx):
        with ctx():
            out, counts = run_counted(torch, counters,
                                      dict.fromkeys(counters, 0), encode)
            t = time.time()
            encode()
            torch.cuda.synchronize()
        return out, counts, (time.time() - t) * 1e3

    import contextlib

    sp = lambda: sequence_sharded_activations(mesh)  # noqa: E731
    want, want_counts, want_ms = timed(contextlib.nullcontext)
    out = {"one": {"counts": want_counts, "ms": want_ms,
                   "want": tower_launches(acfg)}}
    for mode in TP_MODES:
        if mode == "tp":
            shard_vision_tower(tower, mesh)
        got, counts, ms = timed(sp if "sp" in mode else contextlib.nullcontext)
        out[mode] = {"cos": cos_min(torch, got, want),
                     "err": abs_err(got, want), "counts": counts, "ms": ms,
                     "want": tower_launches(acfg, tp="tp" in mode)}
    del one, tower
    torch.cuda.empty_cache()
    return out


def tp_step(torch, np, counters, mesh, lora=False):
    """Phase 4tp (b) on one rank: the vitlensL audio + text recipe with the
    whole audio tower trained, its trunk too (text locked), B32 global
    (this data rank's B16 rows), after fsdp_tp_place, from the placed
    initial state each time: the 2D step in bf16 (the trainer's --tp
    path), the same under sequence_sharded_activations (TP + SP), and the
    2D step in fp32 (with remat). Rank 0 first runs the one-process B32
    steps from the same state: bf16 plain and with accum_freq 2 (the same
    gradient at other shapes: their cosine is the one-process bf16 floor),
    and fp32 (with remat).
    Each 2D step against its dtype's plain step: loss, grad_norm, the
    gradient cosine a group of tp_groups. Each rank's launches, trunk
    weight bytes (whole and its own) and peak memory. ``lora``: (b)'s LoRA
    variant, phase 4l's recipe (attach_lora_: the audio trunk's factors
    alone trained, whole on every model rank, its base weights split),
    the bf16 and fp32 2D steps (TP_LORA_STEPS)."""
    import contextlib

    import torch.distributed as dist

    from vitlens_tpu_torch.factory import create_model, make_trainable_
    from vitlens_tpu_torch.parallel import fsdp as F
    from vitlens_tpu_torch.parallel.sp import sequence_sharded_activations
    from vitlens_tpu_torch.parallel.tp import split_params
    from vitlens_tpu_torch.train.freeze import tri_model_mask
    from vitlens_tpu_torch.train.step import (OptimizerConfig, StepConfig,
                                              init_train_state, make_optimizer,
                                              make_train_step)

    t0 = time.time()
    first = mesh.rank == 0 and mesh.model_rank == 0
    torch.cuda.reset_peak_memory_stats()
    model = create_model("ViT-L-14", "audio", seed=SEED, device="cuda",
                         dtype=torch.float32)
    tp_biases_(torch, model.visual)
    cfg, dev = model.cfg, model.logit_scale.device
    rng = np.random.RandomState(SEED)  # the same B32 batch on every rank
    text = rng.randint(1, 49000, size=(TP_B, 77))
    text[:, 0], text[:, -1] = 49406, 49407
    a = cfg.tower.audio
    fb = rng.randn(TP_B, a.target_length, a.mel_bins) * 0.5
    batch = {"text": torch.from_numpy(text).long().to(dev),
             "visual": torch.from_numpy(fb.astype(np.float32)).to(dev)}
    sc = StepConfig(n_tower=2, align_to="text", compute_dtype=torch.bfloat16)
    mask = tri_model_mask(model, cfg, lock_visual=lora, lock_text=True)
    if lora:
        mask = attach_lora_(torch, model, mask)
    tx, mask = make_optimizer(model, OptimizerConfig(
        lr=1e-4, warmup=10, total_steps=1000, grad_clip_norm=1.0), mask)
    make_trainable_(model, mask, torch.bfloat16)
    names = [n for n, t in mask.items() if t]
    params = dict(model.named_parameters())
    trunk_whole = sum(p.numel() * p.element_size() for n, p in params.items()
                      if n.startswith("visual.trunk."))
    out = {"trunk_whole_gb": trunk_whole / 1e9}
    ref = {}
    if first:  # its peak is read apart from the 2D steps'
        torch.cuda.reset_peak_memory_stats()
        init = {n: params[n].detach().clone() for n in names}
        for key, accum, dtype in (("bf16", 1, torch.bfloat16),
                                  ("accum2", 2, torch.bfloat16),
                                  ("fp32", 1, torch.float32)):
            state = init_train_state(model, tx)
            step = make_train_step(cfg, tx, mask, dataclasses.replace(
                sc, accum_freq=accum, compute_dtype=dtype,
                remat=dtype == torch.float32))
            ((_, met), grads), _ = run_counted(
                torch, counters, dict.fromkeys(counters, 0),
                lambda: grabbed_step(torch, tx, step, state, batch))
            ref[key] = ({k: float(v) for k, v in met.items()},
                        {n: g.cpu() for n, g in grads.items()})
            del grads, state
            with torch.no_grad():
                for n in names:
                    params[n].copy_(init[n])
        del init
        out["floor"] = tp_cosines(torch, ref["accum2"][1], ref["bf16"][1], names)
        out["single"] = {k: v[0] for k, v in ref.items()}
        out["single_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    dist.barrier()
    state = init_train_state(model, tx)
    F.fsdp_tp_place(state, mesh)
    split = split_params(model)
    out["trunk_rank_gb"] = sum(
        F.local_tensor(p).numel() * p.element_size()
        for n, p in model.named_parameters() if n.startswith("visual.trunk.")) / 1e9
    out["split"] = len(split)
    live = [F.local_tensor(p) for p in model.parameters()] + [
        F.local_tensor(t) for m in ("mu", "nu") for t in state.opt_state[m].values()]
    start = [t.detach().clone() for t in live]
    d = mesh.rank
    rows = {k: v[d * TP_B // mesh.data:(d + 1) * TP_B // mesh.data]
            for k, v in batch.items()}
    steps = TP_LORA_STEPS if lora else TP_STEPS
    for mode, dtype in steps.items():
        dtype = getattr(torch, dtype)
        with torch.no_grad():
            for t, s0 in zip(live, start):
                t.copy_(s0)
        state.step, state.opt_state["count"] = 0, 0
        # fp32 with remat (both sides): four ranks' fp32 activations at
        # once would not fit on the one card
        step = make_train_step(cfg, tx, mask, dataclasses.replace(
            sc, compute_dtype=dtype, remat=dtype == torch.float32),
            mesh=mesh, partition="fsdp")
        ctx = (sequence_sharded_activations(mesh) if mode == "tpsp"
               else contextlib.nullcontext())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        with ctx:
            ((_, met), grads), counts = run_counted(
                torch, counters, dict.fromkeys(counters, 0),
                lambda: grabbed_step(torch, tx, step, state, rows, split=split))
        r = {"metrics": {k: float(v) for k, v in met.items()},
             "counts": counts, "step_s": time.time() - t,
             "want": (launch_counts() if dtype == torch.float32 else
                      train_launches(cfg.tower, cfg.text.layers, 1, False,
                                     False, tp=True))}
        if first:
            one = ref["fp32" if dtype == torch.float32 else "bf16"]
            r["loss_rel"] = abs(r["metrics"]["loss"] / one[0]["loss"] - 1)
            r["grad_norm_rel"] = abs(r["metrics"]["grad_norm"]
                                     / one[0]["grad_norm"] - 1)
            r["cos"] = tp_cosines(torch, grads, one[1], names)
        out[mode] = r
        del grads
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()  # the other ranks share the card
    out["peak_gb"] = max(out[m]["peak_gb"] for m in steps)
    del model, state, step, live, start, ref, params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    return out


def tp_rank_main(out_dir, lora_only=False) -> int:
    """A rank process of phase 4tp, started by tp_ranks_phase with
    torchrun's variables: one of four gloo ranks sharing the card, laid out
    [data 2, model 2] by make_mesh(n_model=2); (a) tp_encode, (b) tp_step
    and its LoRA variant, then phase 4pp (pp_rank) on its pipe meshes;
    results to rank{r}.json. ``lora_only``: the LoRA parts alone (4tp (b)'s
    variant and 4pp (c)'s)."""
    import datetime
    import faulthandler

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vitlens_tpu_torch.parallel import mesh as PM

    faulthandler.enable()
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=300))
    mesh = PM.make_mesh(n_model=TP_MODEL, device="cuda:0")
    layout = (mesh.data, mesh.model, mesh.rank, mesh.model_rank, mesh.backend)
    if layout != (world // TP_MODEL, TP_MODEL, rank // TP_MODEL,
                  rank % TP_MODEL, "gloo"):
        fail(f"4tp: mesh layout {layout} on rank {rank}")
    counters = launch_counters()
    res = {"rank": rank}
    if not lora_only:
        res["encode"] = tp_encode(torch, np, counters, mesh)
        dist.barrier()
        res["step"] = tp_step(torch, np, counters, mesh)
        dist.barrier()
    res["step_lora"] = tp_step(torch, np, counters, mesh, lora=True)
    dist.barrier()
    res["pp"] = pp_rank(torch, np, counters, rank, lora_only)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def run_ranks(label, world, rank_argv, limit_s=600):
    """Start ``world`` rank processes of ``rank_argv`` + [output dir] with
    torchrun's variables (one card, LOCAL_RANK 0), wait for them (a rank
    that fails or outlives ``limit_s`` fails the phase, with every rank's
    log), and return their rank{r}.json results."""
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    port = str(free_port())
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        logs.append(os.path.join(out_dir, f"rank{r}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(rank_argv + [out_dir], stdout=f,
                                          stderr=subprocess.STDOUT, env=env))
    deadline, err = time.time() + limit_s, None
    while any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if bad or time.time() > deadline:
            err = (f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad
                   else f"the join's {limit_s} s ran out")
            break
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if err is None and any(p.returncode for p in procs):
        err = f"exit codes {[p.returncode for p in procs]}"
    if err:
        for r, log in enumerate(logs):
            print(f"--- {label} rank {r} log (tail) ---\n"
                  + open(log).read()[-4000:], flush=True)
        fail(f"{label}: {err}")
    res = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
           for r in range(world)]
    shutil.rmtree(out_dir, ignore_errors=True)
    return res


def tp_step_check(res, key, totals, card):
    """Phase 4tp (b)'s bars on the ranks' ``key`` steps (tp_step's: "step",
    or "step_lora" for its LoRA variant), and their lines."""
    s0 = res[0][key]
    floor = s0["floor"]
    lora = key == "step_lora"
    for mode, dtype in (TP_LORA_STEPS if lora else TP_STEPS).items():
        r0, one = s0[mode], s0["single"]["fp32" if dtype == "float32" else "bf16"]
        for r, got in enumerate(res):
            st = got[key][mode]
            if st["counts"] != st["want"]:
                fail(f"4tp (b) rank {r} {key} {mode}: launches {st['counts']}, "
                     f"expected {st['want']}")
            if st["metrics"] != r0["metrics"]:
                fail(f"4tp (b) {key} {mode}: the ranks' metrics differ: "
                     f"{r0['metrics']} vs rank {r} {st['metrics']}")
            for name, n in st["counts"].items():
                totals[name] += n
        if dtype == "float32":  # rounding noise far below the bar
            low = {k: v for k, v in r0["cos"].items() if v < DP_COS_MIN}
            bar = f"{DP_COS_MIN}"
        else:  # bf16: the one-process floor of the same gradient
            low = {k: v for k, v in r0["cos"].items()
                   if v < COS_MIN or v < floor[k] - DP_FLOOR_SLACK}
            bar = (f"{COS_MIN} and the one-process bf16 floor (B{TP_B} "
                   f"against accum_freq 2) less {DP_FLOOR_SLACK}")
        if (r0["loss_rel"] > DP_LOSS_REL or r0["grad_norm_rel"] > DP_NORM_REL
                or low):
            fail(f"4tp (b) {key} {mode} ({dtype}): the 2D step vs the one-process "
                 f"B{TP_B} step: loss {r0['metrics']['loss']} vs "
                 f"{one['loss']} (relative {r0['loss_rel']:.3e}, bar "
                 f"{DP_LOSS_REL}), grad_norm {r0['metrics']['grad_norm']} vs "
                 f"{one['grad_norm']} (relative {r0['grad_norm_rel']:.3e}, bar "
                 f"{DP_NORM_REL}); groups below the bar ({bar}): {low}"
                 + ("" if dtype == "float32" else
                    f"; their floors {({k: floor[k] for k in low})}"))
        worst = sorted(r0["cos"].items(), key=lambda kv: kv[1])[:3]
        print(f"[4tp (b) {'TP + SP' if mode == 'tpsp' else 'TP'} "
              f"{'LoRA ' if lora else ''}step, {dtype}, 4 gloo ranks] {card} | "
              "vitlensL audio + text ("
              + (f"LoRA rank {LORA_RANK} on the four targets of the split "
                 "audio trunk, the factors alone trained, whole on each model "
                 "rank" if lora else "the whole audio tower trained")
              + f", text locked), B{TP_B // 2} a data "
              f"rank, fsdp_tp_place ({s0['split']} TP slices) vs one process "
              f"at B{TP_B}: loss {r0['metrics']['loss']:.6f} vs "
              f"{one['loss']:.6f} (relative {r0['loss_rel']:.3e}, bar "
              f"{DP_LOSS_REL}), grad_norm {r0['metrics']['grad_norm']:.6f} vs "
              f"{one['grad_norm']:.6f} (relative {r0['grad_norm_rel']:.3e}, "
              f"bar {DP_NORM_REL}); {len(r0['cos'])} gradient groups, lowest "
              "cosines " + ", ".join(
                  f"{k} {v:.6f}" + ("" if dtype == "float32" else
                                    f" (floor {floor[k]:.6f})")
                  for k, v in worst)
              + f" (bar {bar}); launches each rank {r0['counts']} (as "
              "expected: kernel 2 on the rank's heads, no kernel 1 in a "
              "split block); step s a rank " + ", ".join(
                  f"{g[key][mode]['step_s']:.2f}" for g in res)
              + " (first calls, host-timed)", flush=True)


def tp_ranks_phase(torch, totals, card, rank_argv=None, lora_only=False):
    """Phase 4tp: four rank processes sharing the card over gloo, [data 2,
    model 2] (tp_rank_main). (a) the full-width vitlensL audio encode at B8
    under SP, TP and TP + SP against the one-process encode (cosine >=
    DP_ENCODE_COS), launches a rank as tower_launches derives them; (b) the
    B32 audio + text step after fsdp_tp_place against the one-process B32
    step: in bf16, TP and TP + SP (loss DP_LOSS_REL, grad_norm DP_NORM_REL,
    the gradient cosine a group of tp_groups >= COS_MIN and the one-process
    floor less DP_FLOOR_SLACK: a bf16 gradient that comes back through 24
    blocks computed at other shapes reads ~0.998, as 4dp (b) found, and the
    split products are other shapes), launches as train_launches(tp=True);
    in fp32, TP (the same loss and grad_norm bars, every group's cosine >=
    DP_COS_MIN; no kernel launches: the gates send fp32 to the plain
    paths); equal metrics on every rank, each rank's trunk weight bytes
    half the whole (TP_BYTES_SLACK) and its peak memory. Returns the
    phase's seconds. (b)'s LoRA variant (tp_step(lora=True)) takes the same
    bars on its bf16 and fp32 steps. ``rank_argv``: the command of a rank
    before its output directory (default: this script's ``--tp-rank``);
    ``lora_only``: the ranks run the LoRA parts of 4tp (b) and 4pp (c)
    alone."""
    t0 = time.time()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    res = run_ranks("4tp", TP_WORLD, rank_argv or [
        sys.executable, os.path.abspath(__file__), "--tp-rank"]
        + (["--lora"] if lora_only else []))
    if not lora_only:
        tp_encode_check(res, totals, card)
    for key in ("step", "step_lora"):
        if key in res[0]:
            tp_step_check(res, key, totals, card)
    for r, got in enumerate(res):
        for key in ("step", "step_lora"):
            st = got.get(key)
            if st and abs(st["trunk_rank_gb"] / st["trunk_whole_gb"]
                          - 0.5) > TP_BYTES_SLACK:
                fail(f"4tp (b) rank {r} {key}: trunk weight bytes "
                     f"{st['trunk_rank_gb']} GB of {st['trunk_whole_gb']} GB "
                     "whole, not half")
    for key, steps in (("step", TP_STEPS), ("step_lora", TP_LORA_STEPS)):
        if key not in res[0]:
            continue
        s0 = res[0][key]
        print(f"[4tp (b) memory, {key}] {card} | audio trunk weight GB a rank "
              + ", ".join(f"{g[key]['trunk_rank_gb']:.4f}" for g in res)
              + f" of {s0['trunk_whole_gb']:.4f} whole; peak GB a rank, the 2D "
              "steps (" + ", ".join(steps) + "): " + "; ".join(
                  ", ".join(f"{g[key][m]['peak_gb']:.2f}" for m in steps)
                  for g in res)
              + f"; rank 0's one-process B{TP_B} steps "
              f"{s0['single_peak_gb']:.2f}; this process resident "
              f"{resident:.2f}; in the ranks "
              + ("(a) + (b) " if key == "step" else "")
              + ", ".join(f"{g[key]['seconds']:.1f}" for g in res)
              + " s of (b)", flush=True)
    pp_check(res, totals, card)
    print(f"[4tp] {card} | phase {time.time() - t0:.1f} s with 4pp",
          flush=True)
    return time.time() - t0


def tp_encode_check(res, totals, card):
    """Phase 4tp (a)'s bars on the ranks' encodes, and its line."""
    for r, got in enumerate(res):
        for mode in ("one",) + TP_MODES:
            e = got["encode"][mode]
            if e["counts"] != e["want"]:
                fail(f"4tp (a) rank {r} {mode}: launches {e['counts']}, "
                     f"expected {e['want']}")
            if mode != "one" and e["cos"] < DP_ENCODE_COS:
                fail(f"4tp (a) rank {r} {mode}: the encode vs the one-process "
                     f"encode: cosine {e['cos']} (bar {DP_ENCODE_COS}), max "
                     f"abs difference {e['err']}")
            for name, n in e["counts"].items():
                totals[name] += n
    e0 = res[0]["encode"]
    print(f"[4tp (a) encodes, 4 gloo ranks, [data 2, model 2]] {card} | "
          f"vitlensL audio (trunk cut to {CUT_DEPTH} blocks) "
          f"B{TP_ENCODE_B} x 3 clips, bf16, each data row a "
          "[data 1, model 2] pair: min cosine against the one-process encode "
          + ", ".join(f"{m} {min(g['encode'][m]['cos'] for g in res):.7f}"
                      for m in TP_MODES)
          + f" (bar {DP_ENCODE_COS}); rank 0 launches a mode (kernel 1, "
          "kernel 2): " + ", ".join(
              f"{m} ({e0[m]['counts']['fused_mlp']}, "
              f"{e0[m]['counts']['flash_attention']})" for m in ("one",) + TP_MODES)
          + "; host ms an encode (second call) " + ", ".join(
              f"{m} {e0[m]['ms']:.1f}" for m in ("one",) + TP_MODES), flush=True)


# -- phase 4pp: pipelining (ROADMAP Queue 1 item 12d) ---------------------------

PP_WORLD = 4
# (a): (stages, data rows, microbatches): 6 blocks a stage at microbatch 6,
# and 12 blocks a stage on each data row's 4 requests (microbatch 6)
PP_ENCODE_LAYOUTS = ((4, 1, 4), (2, 2, 2))
PP_G_LAYOUT = (4, 1, 4)     # (b): 8 of the 32 bigG blocks that run, a stage
PP_G_B = 16
PP_GRAD_LAYOUT = (4, 1, 4)  # (c)
PP_GRAD_B = 16
PP_LOSS_REL = 1e-4          # (c) fp32: the pipelined loss against one process's
PP_EQUAL_REL = 1e-4         # (c): a replicated gradient on a rank against rank
                            # 0's (the same inputs; cuDNN's weight gradients
                            # may sum in another order)
PP_BYTES_SLACK = 0.01       # a rank's bytes of the blocks that run within 1%
                            # of 1 / stages of the whole's


def block_bytes(trunk, indices):
    """Bytes of the parameters this rank holds of the trunk blocks
    ``indices`` (a block placed on another stage holds none)."""
    return sum(p.numel() * p.element_size() for i in indices
               for p in trunk.blocks[i].parameters())


def pp_timed(torch, counters, model, modality, x):
    """(embeddings, launches, host ms of a second call) of
    ``model.encode({modality: x})``."""
    def encode():
        return model.encode({modality: x}, preprocessed=True)[modality]

    out, counts = run_counted(torch, counters, dict.fromkeys(counters, 0), encode)
    t = time.time()
    encode()
    torch.cuda.synchronize()
    return out, counts, (time.time() - t) * 1e3


def pp_encode(torch, counters):
    """Phase 4pp (a) on one rank: ViTLens("vitlensL", ("audio",)) in bf16,
    B8 requests of 3 clips: the one-process encode, then for each layout of
    PP_ENCODE_LAYOUTS a copy of the model placed by pipeline_place, this
    data row's requests encoded under pipelined_trunks. The cosine of each
    against the one-process encode's rows, its launches, the rank's trunk
    weight bytes against the whole's, and host ms an encode (the second of
    two calls)."""
    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.parallel.pp import (make_pipe_mesh, pipeline_place,
                                               pipelined_trunks)

    one = ViTLens("vitlensL", ("audio",), device="cuda",
                  compute_dtype=torch.bfloat16, seed=SEED)
    acfg = one.towers["audio"].cfg
    g = torch.Generator(device="cuda").manual_seed(SEED)
    fb = torch.randn(TP_ENCODE_B, 3, acfg.audio.target_length,
                     acfg.audio.mel_bins, generator=g, device="cuda") * 0.5
    want, counts, ms = pp_timed(torch, counters, one, "audio", fb)
    layers = range(acfg.arch.layers)
    out = {"one": {"counts": counts, "want": tower_launches(acfg), "ms": ms},
           "trunk_whole_gb": block_bytes(one.towers["audio"].trunk, layers) / 1e9}
    for stages, n_data, m in PP_ENCODE_LAYOUTS:
        mesh = make_pipe_mesh(stages, n_data, device="cuda:0")
        model = copy.deepcopy(one)
        pipeline_place(model.towers["audio"], mesh)
        torch.cuda.empty_cache()
        b = TP_ENCODE_B // n_data
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        with pipelined_trunks(mesh, m):
            got, counts, ms = pp_timed(torch, counters, model, "audio", fb[rows])
        out[f"{n_data}x{stages}"] = {
            "cos": cos_min(torch, got, want[rows]),
            "err": abs_err(got, want[rows]), "counts": counts, "ms": ms,
            "want": tower_launches(acfg, pp=(stages, m)),
            "trunk_rank_gb": block_bytes(model.towers["audio"].trunk,
                                         layers) / 1e9}
        del model, got
    del one, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pp_vitlensG(torch, counters):
    """Phase 4pp (b) on one rank: ViTLens("vitlensG", ("pc",)) in bf16
    (weights bf16), B16 clouds of 10000 x 6: the one-process encode, then
    the tower placed on the [data 1, pipe 4] mesh (pipeline_place keeps the
    8 blocks of the 32 that run that are this stage's and drops the 16
    skipped ones) and encoded under pipelined_trunks: the cosine, launches,
    the rank's bytes of the blocks that run (and of the skipped ones)
    against the whole's, the peaks (the build and one-process encode; the
    pipelined encode after placement) and host ms."""
    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.parallel.pp import (make_pipe_mesh, pipeline_place,
                                               pipelined_trunks)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one = ViTLens("vitlensG", ("pc",), device="cuda",
                  compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                  seed=SEED)
    tower = one.towers["pc"]
    cfg, pt = tower.cfg, tower.cfg.point
    g = torch.Generator(device="cuda").manual_seed(SEED)
    pc = torch.cat([torch.randn(PP_G_B, pt.npoints, 3, generator=g, device="cuda") * 0.4,
                    torch.rand(PP_G_B, pt.npoints, 3, generator=g, device="cuda")], -1)
    want, counts, ms = pp_timed(torch, counters, one, "pc", pc)
    first, layers = cfg.skip_first_n_layers, cfg.arch.layers
    run, skipped = range(first, layers), range(first)
    out = {"one": {"counts": counts, "want": tower_launches(cfg, fps=1), "ms": ms},
           "run_whole_gb": block_bytes(tower.trunk, run) / 1e9,
           "skipped_whole_gb": block_bytes(tower.trunk, skipped) / 1e9,
           "built_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    stages, n_data, m = PP_G_LAYOUT
    mesh = make_pipe_mesh(stages, n_data, device="cuda:0")
    pipeline_place(tower, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    out["resident_gb"] = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    with pipelined_trunks(mesh, m):
        got, counts, ms = pp_timed(torch, counters, one, "pc", pc)
    out.update({
        "cos": cos_min(torch, got, want), "err": abs_err(got, want),
        "counts": counts, "ms": ms, "want": tower_launches(cfg, pp=(stages, m), fps=1),
        "run_rank_gb": block_bytes(tower.trunk, run) / 1e9,
        "skipped_rank_gb": block_bytes(tower.trunk, skipped) / 1e9,
        "encode_peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    del one, tower, want, got, pc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pp_grad_launches(cfg, lora):
    """Expected launches a rank of one bf16 pass of 4pp (c), derived from
    the config: each stage runs its (layers / stages) audio trunk blocks
    once a microbatch through the save-preact variant (the tower, or its
    LoRA factors, trains) and kernel 2, the Lens its cross and self blocks
    once (it is not pipelined), and the text tower's stage blocks once a
    microbatch through kernel 1: the plain variant while text is locked,
    the save-preact one where its LoRA factors train (its causal attention
    is plain)."""
    stages, _, m = PP_GRAD_LAYOUT
    la = cfg.tower.arch.layers // stages * m
    lt = cfg.text.layers // stages * m
    p = cfg.tower.perceiver
    return launch_counts(
        fused_mlp=0 if lora else lt,
        fused_mlp_save_preact=la + (lt if lora else 0),
        flash_attention=la + p.depth * (1 + p.self_per_cross_attn))


def pp_grads(torch, np, counters, rank, lora=False):
    """Phase 4pp (c) on one rank: the gradient of the audio x text
    contrastive loss (make_loss_fn(2)) at B16 through the vitlensL audio +
    text model (the audio trunk cut to CUT_DEPTH blocks), the whole audio
    tower trainable (its trunk too), text locked. Rank 0 first runs one process's passes: bf16, bf16 at the
    microbatches' shapes (accum_freq 4: the bf16 floor) and fp32 with
    remat. Then the audio tower is placed on the [data 1, pipe 4] mesh and
    the passes run under pipelined_trunks (M = 4; the text tower's 12
    blocks pipeline too, forward only): bf16, and fp32 with remat. Each
    rank's gradients (its stage's blocks and the replicated ones) are
    gathered to rank 0, which holds them against its one-process passes: the
    loss, the cosine a group of tp_groups, and each rank's replicated
    gradients against rank 0's. ``lora``: the variant whose text tower
    trains too, two trained towers pipelined in one backward: phase 4l's
    factors (attach_lora_) on the audio and the text trunk, the factors
    alone trained, both towers placed; a factor's gradient is the stage's
    that runs its block (the others hold zeros), summed over the ranks."""
    import torch.distributed as dist

    from vitlens_tpu_torch.factory import create_model, make_trainable_
    from vitlens_tpu_torch.parallel.pp import (OtherStage, make_pipe_mesh,
                                               pipeline_place, pipelined_trunks)
    from vitlens_tpu_torch.train.freeze import tri_model_mask
    from vitlens_tpu_torch.train.losses import make_loss_fn
    from vitlens_tpu_torch.train.step import (OptimizerConfig, StepConfig,
                                              accum_grads, make_optimizer,
                                              micro_grads)

    model = create_model("ViT-L-14", "audio", seed=SEED, device="cuda",
                         dtype=torch.float32,
                         **({} if lora else {"arch": cut_arch()}))
    cfg, dev = model.cfg, model.logit_scale.device
    rng = np.random.RandomState(SEED)
    text = rng.randint(1, 49000, size=(PP_GRAD_B, 77))
    text[:, 0], text[:, -1] = 49406, 49407
    a = cfg.tower.audio
    fb = rng.randn(PP_GRAD_B, a.target_length, a.mel_bins) * 0.5
    batch = {"text": torch.from_numpy(text).long().to(dev),
             "visual": torch.from_numpy(fb.astype(np.float32)).to(dev)}
    mask = tri_model_mask(model, cfg, lock_visual=lora, lock_text=True)
    if lora:
        mask = attach_lora_(torch, model, mask, towers=("visual", "text"))
    _, mask = make_optimizer(model, OptimizerConfig(
        lr=1e-4, warmup=10, total_steps=1000), mask)
    make_trainable_(model, mask, torch.bfloat16)
    names = [n for n, t in mask.items() if t]
    loss_fn = make_loss_fn(2)
    sc = StepConfig(n_tower=2, align_to="text")
    passes = {"bf16": (torch.bfloat16, False), "fp32": (torch.float32, True)}

    def grads_of(dtype, remat, accum=1):
        s = dataclasses.replace(sc, compute_dtype=dtype, remat=remat,
                                accum_freq=accum)
        mine = {n: p for n, p in model.named_parameters() if p.requires_grad}
        fn = accum_grads if accum > 1 else micro_grads
        (loss, grads), counts = run_counted(
            torch, counters, dict.fromkeys(counters, 0),
            lambda: fn(model, batch, s, mine, loss_fn))
        return float(loss), {n: g.float().cpu() for n, g in grads.items()}, counts

    out, ref = {}, {}
    t = time.time()
    if rank == 0:
        for key, (dtype, remat) in passes.items():
            ref[key] = grads_of(dtype, remat)[:2]
        ref["accum4"] = grads_of(torch.bfloat16, False, PP_GRAD_LAYOUT[2])[:2]
        out["floor"] = tp_cosines(torch, ref["accum4"][1], ref["bf16"][1], names)
        out["single"] = {k: v[0] for k, v in ref.items()}
        out["single_s"] = time.time() - t
        torch.cuda.empty_cache()
    dist.barrier()
    stages, n_data, m = PP_GRAD_LAYOUT
    mesh = make_pipe_mesh(stages, n_data, device="cuda:0")
    pipeline_place(model.visual, mesh)
    if lora:
        pipeline_place(model.text, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    trunk = "visual.trunk.blocks."
    out["held"] = [[i for i, b in enumerate(t.trunk.blocks)
                    if not isinstance(b, OtherStage)]
                   for t in (model.visual, model.text)]
    for key, (dtype, remat) in passes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        with pipelined_trunks(mesh, m):
            loss, grads, counts = grads_of(dtype, remat)
        r = {"loss": loss, "counts": counts, "s": time.time() - t,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "want": (pp_grad_launches(cfg, lora) if dtype == torch.bfloat16
                      else launch_counts())}
        t = time.time()
        every = [None] * dist.get_world_size() if rank == 0 else None
        dist.gather_object(grads, every, dst=0)
        del grads
        if rank == 0:
            one_loss, one = ref[key]
            rep = [n for n in names if not n.startswith(trunk)
                   and ".lora." not in n]
            merged = {n: g for got in every for n, g in got.items()
                      if n.startswith(trunk)}
            merged.update({n: every[0][n] for n in rep})
            merged.update({n: sum(got[n] for got in every)
                           for n in names if ".lora." in n})
            r["missing"] = sorted(set(names) - set(merged))
            r["loss_rel"] = abs(loss / one_loss - 1)
            r["cos"] = tp_cosines(torch, merged, one, names) if not r["missing"] else {}
            r["rep_cos"] = [min(tp_cosines(torch, got, one, rep).values())
                            for got in every]
            r["rep_rel"] = [max(rel_err(got[n], every[0][n]) for n in rep)
                            for got in every]
            r["blocks"] = [sorted({int(n[len(trunk):].split(".")[0])
                                   for n in got if n.startswith(trunk)})
                           for got in every]
            del every, merged
        r["check_s"] = time.time() - t
        out[key] = r
        gc.collect()
        torch.cuda.empty_cache()
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pp_rank(torch, np, counters, rank, lora_only=False):
    """Phase 4pp on one of four gloo ranks sharing the card: (a), (b), (c)
    and (c)'s LoRA variant (``lora_only``: that alone); returns their
    results and the seconds each took on this rank."""
    import torch.distributed as dist

    res, t0 = {}, time.time()
    parts = (("encode", lambda: pp_encode(torch, counters)),
             ("g", lambda: pp_vitlensG(torch, counters)),
             ("grads", lambda: pp_grads(torch, np, counters, rank)),
             ("grads_lora", lambda: pp_grads(torch, np, counters, rank,
                                             lora=True)))
    for name, fn in parts[3:] if lora_only else parts:
        t = time.time()
        res[name] = fn()
        dist.barrier()
        res[name + "_s"] = time.time() - t
    res["seconds"] = time.time() - t0
    return res


def pp_rank_main(out_dir) -> int:
    """A rank process of phase 4pp alone (tools/dp_first_call.py --pp), as
    tp_rank_main starts one: four gloo ranks sharing the card; results to
    rank{r}.json."""
    import datetime
    import faulthandler

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    faulthandler.enable()
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=300))
    res = {"rank": rank, "pp": pp_rank(torch, np, launch_counters(), rank)}
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def pp_grad_check(pp, part, totals, card):
    """Phase 4pp (c)'s bars on the ranks' ``part`` ("grads", or
    "grads_lora" for its LoRA variant), and its lines."""
    c0 = pp[0][part]
    floor = c0["floor"]
    lora = part == "grads_lora"
    label = "4pp (c) LoRA" if lora else "4pp (c)"
    for key in ("bf16", "fp32"):
        r0 = c0[key]
        for r, got in enumerate(pp):
            g = got[part][key]
            if g["counts"] != g["want"]:
                fail(f"{label} {key} rank {r}: launches {g['counts']}, "
                     f"expected {g['want']}")
            for name, n in g["counts"].items():
                totals[name] += n
        if r0["missing"]:
            fail(f"{label} {key}: no rank gave the gradients of {r0['missing'][:6]}")
        if key == "fp32":
            bar_loss, bar = PP_LOSS_REL, f"{DP_COS_MIN}"
            low = {k: v for k, v in r0["cos"].items() if v < DP_COS_MIN}
            rep_low = [c for c in r0["rep_cos"] if c < DP_COS_MIN]
        else:
            bar_loss = DP_LOSS_REL
            bar = (f"{COS_MIN} and the one-process bf16 floor (B{PP_GRAD_B} "
                   f"against accum_freq {PP_GRAD_LAYOUT[2]}) less {DP_FLOOR_SLACK}")
            low = {k: v for k, v in r0["cos"].items()
                   if v < COS_MIN or v < floor[k] - DP_FLOOR_SLACK}
            rep_low = [c for c in r0["rep_cos"] if c < COS_MIN]
        if (r0["loss_rel"] > bar_loss or low or rep_low
                or max(r0["rep_rel"]) > PP_EQUAL_REL):
            fail(f"{label} {key}: the pipelined gradient vs one process's at "
                 f"B{PP_GRAD_B}: loss {r0['loss']} vs {c0['single'][key]} "
                 f"(relative {r0['loss_rel']:.3e}, bar {bar_loss}); groups below "
                 f"the bar ({bar}): {low}; each rank's replicated gradients: "
                 f"lowest group cosine {r0['rep_cos']}, max relative difference "
                 f"from rank 0's {r0['rep_rel']} (bar {PP_EQUAL_REL})")
        worst = sorted(r0["cos"].items(), key=lambda kv: kv[1])[:3]
        held = [g[part]["held"] for g in pp]
        print(f"[{label} pipelined gradient, {key}, 4 gloo ranks, [data 1, "
              f"pipe {PP_GRAD_LAYOUT[0]}], M = {PP_GRAD_LAYOUT[2]}] {card} | "
              f"vitlensL audio x text contrastive loss at B{PP_GRAD_B}, "
              + (f"LoRA rank {LORA_RANK} on the audio and the text trunk, the "
                 "factors alone trainable, both towers pipelined (two trained "
                 "towers in one backward)" if lora else
                 f"the whole audio tower trainable (its trunk cut to "
                 f"{CUT_DEPTH} blocks)")
              + (", remat" if key == "fp32" else "")
              + f": loss {r0['loss']:.6f} vs one process {c0['single'][key]:.6f} "
              f"(relative {r0['loss_rel']:.3e}, bar {bar_loss}); audio, text "
              "blocks a rank "
              f"{[[(b[0], b[-1]) for b in h] for h in held]}; {len(r0['cos'])} "
              "gradient groups, lowest cosines " + ", ".join(
                  f"{k} {v:.6f}" + ("" if key == "fp32" else f" (floor {floor[k]:.6f})")
                  for k, v in worst)
              + f" (bar {bar}); replicated gradients a rank: lowest cosine "
              + ", ".join(f"{c:.6f}" for c in r0["rep_cos"])
              + ", max relative difference from rank 0's "
              + ", ".join(f"{e:.3e}" for e in r0["rep_rel"])
              + f" (bar {PP_EQUAL_REL}); rank 0 launches {r0['counts']} (as "
              "expected); s a pass a rank " + ", ".join(
                  f"{g[part][key]['s']:.2f}" for g in pp)
              + f" (rank 0's gather and check {r0['check_s']:.1f} s); peak GB "
              "a rank " + ", ".join(
                  f"{g[part][key]['peak_gb']:.2f}" for g in pp), flush=True)


def pp_encode_check(pp, totals, card):
    """Phase 4pp (a) and (b)'s bars on the ranks' results, and their
    lines."""
    for r, got in enumerate(pp):
        for part, keys in (("encode", ["one"] + [f"{d}x{s}" for s, d, _ in
                                                 PP_ENCODE_LAYOUTS]),
                           ("g", ["one", None])):
            for k in keys:
                e = got[part] if k is None else got[part][k]
                label = f"4pp ({'a' if part == 'encode' else 'b'}) rank {r} {k or 'pipelined'}"
                if e["counts"] != e["want"]:
                    fail(f"{label}: launches {e['counts']}, expected {e['want']}")
                if "cos" in e and e["cos"] < DP_ENCODE_COS:
                    fail(f"{label}: the encode vs the one-process encode: cosine "
                         f"{e['cos']} (bar {DP_ENCODE_COS}), max abs difference "
                         f"{e['err']}")
                for name, n in e["counts"].items():
                    totals[name] += n
        enc = got["encode"]
        for s, d, _ in PP_ENCODE_LAYOUTS:
            share = enc[f"{d}x{s}"]["trunk_rank_gb"] / enc["trunk_whole_gb"]
            if abs(share * s - 1) > PP_BYTES_SLACK:
                fail(f"4pp (a) rank {r} [data {d}, pipe {s}]: trunk weight "
                     f"bytes {share:.4f} of the whole, not 1/{s}")
        gg = got["g"]
        share = gg["run_rank_gb"] / gg["run_whole_gb"]
        if abs(share * PP_G_LAYOUT[0] - 1) > PP_BYTES_SLACK or gg["skipped_rank_gb"]:
            fail(f"4pp (b) rank {r}: bytes of the blocks that run {share:.4f} of "
                 f"the whole, not 1/{PP_G_LAYOUT[0]}; of the skipped blocks "
                 f"{gg['skipped_rank_gb']} GB")
    e0 = pp[0]["encode"]
    print(f"[4pp (a) pipelined encodes, 4 gloo ranks] {card} | vitlensL audio "
          f"B{TP_ENCODE_B} x 3 clips, bf16, pipeline_place + pipelined_trunks: "
          "min cosine against the one-process encode " + ", ".join(
              f"[data {d}, pipe {s}] M = {m} "
              f"{min(g['encode'][f'{d}x{s}']['cos'] for g in pp):.7f}"
              for s, d, m in PP_ENCODE_LAYOUTS)
          + f" (bar {DP_ENCODE_COS}); rank 0 launches (kernel 1, kernel 2): one "
          f"process ({e0['one']['counts']['fused_mlp']}, "
          f"{e0['one']['counts']['flash_attention']}), " + ", ".join(
              f"[{d}, {s}] ({e0[f'{d}x{s}']['counts']['fused_mlp']}, "
              f"{e0[f'{d}x{s}']['counts']['flash_attention']})"
              for s, d, _ in PP_ENCODE_LAYOUTS)
          + "; audio trunk weight GB a rank " + "; ".join(
              f"[{d}, {s}] " + ", ".join(f"{g['encode'][f'{d}x{s}']['trunk_rank_gb']:.4f}"
                                         for g in pp)
              for s, d, _ in PP_ENCODE_LAYOUTS)
          + f" of {e0['trunk_whole_gb']:.4f} whole; host ms an encode (second "
          "call) a rank: one process " + ", ".join(
              f"{g['encode']['one']['ms']:.1f}" for g in pp) + "; " + "; ".join(
              f"[{d}, {s}] " + ", ".join(f"{g['encode'][f'{d}x{s}']['ms']:.1f}"
                                         for g in pp)
              for s, d, _ in PP_ENCODE_LAYOUTS), flush=True)
    g0 = pp[0]["g"]
    print(f"[4pp (b) pipelined vitlensG pc encode, 4 gloo ranks, [data 1, pipe "
          f"{PP_G_LAYOUT[0]}], M = {PP_G_LAYOUT[2]}] {card} | B{PP_G_B} clouds of "
          "10000 x 6, bf16, weights bf16, 32 of 48 bigG blocks run: min cosine "
          f"{min(g['g']['cos'] for g in pp):.7f} (bar {DP_ENCODE_COS}); rank 0 "
          f"launches (kernel 1, kernel 2, FPS): one process "
          f"({g0['one']['counts']['fused_mlp']}, "
          f"{g0['one']['counts']['flash_attention']}, {g0['one']['counts']['fps']}), "
          f"pipelined ({g0['counts']['fused_mlp']}, "
          f"{g0['counts']['flash_attention']}, {g0['counts']['fps']}); GB a rank "
          "of the blocks that run " + ", ".join(
              f"{g['g']['run_rank_gb']:.4f}" for g in pp)
          + f" of {g0['run_whole_gb']:.4f} whole, of the 16 skipped blocks "
          + ", ".join(f"{g['g']['skipped_rank_gb']:.4f}" for g in pp)
          + f" (one process holds {g0['skipped_whole_gb']:.4f}); peak GB a rank: "
          "the build and one-process encode " + ", ".join(
              f"{g['g']['built_peak_gb']:.2f}" for g in pp)
          + ", resident after placement " + ", ".join(
              f"{g['g']['resident_gb']:.2f}" for g in pp)
          + ", the pipelined encode " + ", ".join(
              f"{g['g']['encode_peak_gb']:.2f}" for g in pp)
          + "; host ms an encode (second call) a rank: one process " + ", ".join(
              f"{g['g']['one']['ms']:.1f}" for g in pp) + "; pipelined "
          + ", ".join(f"{g['g']['ms']:.1f}" for g in pp), flush=True)


def pp_check(res, totals, card):
    """Phase 4pp's bars on the ranks' results (pp_rank's): (a) and (b) each
    rank's cosine against the one-process encode >= DP_ENCODE_COS, launches
    as tower_launches(pp=) derives them, its trunk bytes 1 / stages of the
    whole (b: of the blocks that run; the skipped ones none); (c) the loss
    (fp32 PP_LOSS_REL, bf16 DP_LOSS_REL) and each group's gradient cosine
    (fp32 >= DP_COS_MIN; bf16 >= COS_MIN and the one-process floor at the
    microbatches' shapes less DP_FLOOR_SLACK), every trainable tensor's
    gradient present once gathered, and each rank's replicated gradients
    within PP_EQUAL_REL of rank 0's and at the same bars. Prints the phase's
    lines; returns its seconds in the ranks. (c)'s LoRA variant, where the
    ranks ran it, takes (c)'s bars and launches as pp_grad_launches derives
    them."""
    pp = [r["pp"] for r in res]
    if "encode" in pp[0]:
        pp_encode_check(pp, totals, card)
    for part in ("grads", "grads_lora"):
        if part in pp[0]:
            pp_grad_check(pp, part, totals, card)
    secs = max(g["seconds"] for g in pp)
    print(f"[4pp] {card} | in the ranks " + "; ".join(
        f"{label} " + ", ".join(f"{g[part + '_s']:.1f}" for g in pp) + " s"
        for part, label in (("encode", "(a)"), ("g", "(b)"), ("grads", "(c)"),
                            ("grads_lora", "(c) LoRA")) if part in pp[0])
        + " (rank 0's one-process passes " + ", ".join(
            f"{pp[0][part]['single_s']:.1f}" for part in ("grads", "grads_lora")
            if part in pp[0])
        + f" s); phase 4pp {secs:.1f} s", flush=True)
    return secs


def pp_ranks_phase(torch, totals, card, rank_argv=None):
    """Phase 4pp in four rank processes of its own (pp_rank_main; in the
    whole script it runs in 4tp's ranks, tp_rank_main). Returns the seconds
    of the phase's command."""
    t0 = time.time()
    res = run_ranks("4pp", PP_WORLD, rank_argv or [
        sys.executable, os.path.abspath(__file__), "--pp-rank"])
    pp_check(res, totals, card)
    return time.time() - t0


# -- phase 4o: the OpenShape trainer (vitlensG, the pc baselines) ----------------

OS_B = 16             # the OpenShape CLI's default batch
OS_STEPS = 3          # full-width CLIPBind steps
OS_CLI_OBJECTS = 32   # fixture triplets of the CLI runs (2 steps an epoch)
OS_DISK_GB = 40       # epoch_1, epoch_2 and epoch_latest (+ its tmp copy) of ~8.6 GB
# fp32 baselines on the card against the CPU: cuBLAS and the CPU sum in other
# orders (1e-6 a product); TF32 products (10-bit mantissas) would read ~1e-3
BASELINE_TOL = {False: 1e-3, True: 2e-2}


def openshape_batch(torch, g, b, n=10000, width=1280):
    """Fixture triplets on the card: clouds [b, n, 6] (xyz ~ N(0, 0.4), rgb
    in [0, 1]; every other cloud xyz-only, its rgb OpenShape's 0.4 grey)
    and random CLIP text and image features."""
    xyz = torch.randn(b, n, 3, generator=g, device="cuda") * 0.4
    rgb = torch.rand(b, n, 3, generator=g, device="cuda")
    rgb[1::2] = 0.4
    return {"xyz_features": torch.cat([xyz, rgb], -1),
            "text_feat": torch.randn(b, width, generator=g, device="cuda"),
            "img_feat": torch.randn(b, width, generator=g, device="cuda")}


def openshape_launches(cfg, train):
    """Launches of one bf16 CLIPBind pass, from tower_launches: kernel 1 in
    each trunk block that runs (the save-preact variant where autograd
    records), kernel 2 there and in the Lens, FPS once (PNSA)."""
    want = tower_launches(cfg, fps=1)
    if train:
        want["fused_mlp_save_preact"], want["fused_mlp"] = want["fused_mlp"], 0
    return want


def bind_optimizer(torch, model, trunk=True, warmup=2):
    """make_openshape_optimizer with the CLI's defaults (lr 5e-4, wd 0.2,
    the ndim >= 2 mask, 0.1 on the trunk), every parameter trained."""
    from vitlens_tpu_torch.train import openshape as OS
    from vitlens_tpu_torch.train.step import make_openshape_optimizer

    model.requires_grad_(True)
    scale = (OS.trunk_lr_scale(model) if trunk
             else {n: 1.0 for n, _ in model.named_parameters()})
    tx = make_openshape_optimizer(model, lr=5e-4, warmup=warmup,
                                  total_steps=1000, weight_decay=0.2,
                                  decay=OS.ndim_wd_mask(model), lr_scale=scale)
    return tx, tx.init(model), OS.make_openshape_step(
        tx, compute_dtype=torch.bfloat16)


def peak_gb(torch):
    return torch.cuda.max_memory_allocated() / 1e9


def openshape_phase(torch, np, counters, totals, card):
    """Phase 4o and its phase-5 timings: the CLIPBind step at full vitlensG
    width (3 steps at B16: launches, the skipped blocks' decay-only closed
    form, logit_scale moved, an eval batch), the B = 2 gradients of a
    bigG-width tower of 8 trunk blocks against the CPU in fp32, the three
    baselines (a train step each, a B = 2 forward against the CPU) and a
    PointNet2 forward, the PointTransformer's bf16 eval against the CPU,
    then the CLI's train, resume and eval-only runs at full width."""
    from vitlens_tpu_torch.train import openshape as OS

    t0 = time.time()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    fps_gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = OS.vitlensG_tower_config()
    model = OS.CLIPBind(cfg, 1280, device="cuda")
    model.init_(torch.Generator(device="cuda").manual_seed(SEED))
    tx, opt, step = bind_optimizer(torch, model)
    n_params = sum(p.numel() for p in model.parameters())
    skip = cfg.skip_first_n_layers
    # on the host: the step's peak leaves the card ~7 GB when the earlier
    # phases' models stay resident
    skipped = {n: p.detach().cpu() for n, p in model.named_parameters()
               if n.startswith("backbone.trunk.blocks.")
               and int(n.split(".")[3]) < skip}
    if not all(tx.decay[n] and tx.lr_scale[n] == 0.1 for n in skipped):
        fail("4o: a skipped block's tensor is not decayed at the trunk's scale")
    scale0 = model.logit_scale.item()
    want_train, want_eval = openshape_launches(cfg, True), openshape_launches(cfg, False)
    if (want_train["fused_mlp_save_preact"], want_train["flash_attention"],
            want_train["fps"]) != (32, 40, 1):
        fail(f"4o: launches derived from the vitlensG config {want_train}")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(OS_STEPS):
        batch = openshape_batch(torch, g, OS_B)
        m, counts = run_counted(torch, counters, totals,
                                lambda: step(model, opt, batch, fps_generator=fps_gen))
        if counts != want_train:
            fail(f"4o step {i}: launches {counts}, expected {want_train}")
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"4o step {i}: metrics {m}")
        losses.append(round(m["loss"], 5))
    step_peak = peak_gb(torch)
    factor = 1.0
    for c in range(OS_STEPS):
        factor *= 1 - tx.schedule(c) * 0.2 * 0.1
    decay_err = max(rel_err(model.get_parameter(n).detach().cpu(), p0 * factor)
                    for n, p0 in skipped.items())
    moments = max(max(opt["mu"][n].abs().max().item(),
                      opt["nu"][n].abs().max().item()) for n in skipped)
    if decay_err > 2e-6 or moments != 0:  # fp32 rounding of 3 updates
        fail(f"4o: skipped blocks off p * prod(1 - lr_t wd 0.1) by {decay_err} "
             f"(moments {moments})")
    del skipped
    if model.logit_scale.item() == scale0:
        fail("4o: logit_scale did not move")
    with torch.no_grad():
        emb, counts = run_counted(torch, counters, totals, lambda: model(
            batch["xyz_features"], torch.bfloat16))
    if counts != want_eval or tuple(emb.shape) != (OS_B, 1280) or \
            not torch.isfinite(emb).all():
        fail(f"4o eval batch: launches {counts} (expected {want_eval}), shape "
             f"{tuple(emb.shape)}")
    print(f"[4o openshape] CLIPBind (vitlensG: PNSA 10000 x 6, bigG Lens, "
          f"{skip} of 48 trunk blocks skipped, out 1280) bf16 compute, fp32 "
          f"masters, {n_params} parameters ({resident:.2f} GB resident before): "
          f"{OS_STEPS} steps at B{OS_B}, losses {losses}, launches a step "
          f"{want_train['fused_mlp_save_preact']} save-preact kernel 1, "
          f"{want_train['flash_attention']} kernel 2, {want_train['fps']} FPS; "
          f"peak {step_peak:.2f} GB; skipped blocks at p * prod(1 - lr_t * "
          f"wd * 0.1) within {decay_err:.2e} (moments 0); logit_scale "
          f"{scale0:.6f} -> {model.logit_scale.item():.6f}; eval batch "
          f"{want_eval['fused_mlp']} plain kernel 1, {want_eval['flash_attention']} "
          f"kernel 2, 1 FPS", flush=True)
    step_rate = train_rate(torch, card, f"CLIPBind (vitlensG) train step B{OS_B} "
                           "bf16, fp32 masters and AdamW", lambda: step(
                               model, opt, batch, fps_generator=fps_gen), OS_B)
    kernels, busy = profile_encode(torch, card, f"B{OS_B} CLIPBind train step",
                                   lambda: step(model, opt, batch,
                                                fps_generator=fps_gen))
    attn_ms = sum(e.self_device_time_total for e in kernels
                  if "flash_fwd" in e.key) / 1e3
    mlp_ms = sum(e.self_device_time_total for e in kernels
                 if "gemm_tma" in e.key or "fused_mlp" in e.key) / 1e3
    print(f"[5 timing] {card} | CLIPBind step B{OS_B}: kernel 2 (head dim "
          f"104) {attn_ms:.2f} ms = {attn_ms / busy:.3f} of {busy:.2f} ms "
          f"busy; kernel 1 {mlp_ms:.2f} ms = {mlp_ms / busy:.3f}", flush=True)
    del model, opt, tx, step, batch, emb
    torch.cuda.empty_cache()

    grad_line = openshape_grad_parity(torch, np, cfg, g)
    base_rates = openshape_baselines(torch, np, counters, totals, card, g)
    pt_rate = point_transformer_phase(torch, np, counters, totals, card, g)
    cli = openshape_cli_phase(torch, np, counters, totals, card)
    print(f"[4o openshape] {grad_line}; phase took {time.time() - t0:.1f} s",
          flush=True)
    return {"step": step_rate, **base_rates, "point_transformer": pt_rate,
            **cli}


def openshape_grad_parity(torch, np, cfg, g):
    """The B = 2 gradients of a bigG-width CLIPBind cut to 8 trunk blocks
    (the first 4 skipped) and a Lens of depth 1 (a full fp32 copy does not
    fit the host), bf16 on the card against fp32 on the CPU: FPS from the
    same starts, the CPU pass given the card's ball-query groups, clouds
    rounded through bf16 once. Gradient cosine >= COS_MIN, loss within
    LOSS_TOL."""
    from vitlens_tpu_torch.adapters import tokenizers as T
    from vitlens_tpu_torch.train import openshape as OS
    from vitlens_tpu_torch.train.step import _grads

    small = dataclasses.replace(
        cfg, arch=dataclasses.replace(cfg.arch, layers=8), skip_first_n_layers=4,
        perceiver=dataclasses.replace(cfg.perceiver, depth=1))
    model = OS.CLIPBind(small, 1280, device="cuda")
    model.init_(torch.Generator(device="cuda").manual_seed(SEED + 1))
    model.requires_grad_(True)
    batch = openshape_batch(torch, g, 2)
    batch["xyz_features"] = batch["xyz_features"].bfloat16().float()
    starts = torch.tensor([17, 4242], dtype=torch.int32) % batch[
        "xyz_features"].shape[1]
    ref = copy.deepcopy(model).cpu()

    def grads_of(m, dt):
        dev = m.logit_scale.device
        loss, _ = OS.openshape_loss(m, {k: v.to(dev) for k, v in batch.items()},
                                    compute_dtype=dt, fps_start=starts.to(dev))
        gr = _grads(loss, dict(m.named_parameters()))
        return loss.item(), torch.cat([t.float().flatten().cpu()
                                       for t in gr.values()]).double()

    t0 = time.time()
    (loss_card, g_card), (loss_cpu, g_cpu), note = shared_knn_groups(
        torch, lambda: grads_of(model, torch.bfloat16),
        lambda: grads_of(ref, torch.float32), sites=[(T, "ball_query")])
    cos = (g_card @ g_cpu / (g_card.norm() * g_cpu.norm())).item()
    ratio = g_card.norm().item() / g_cpu.norm().item()
    del model, ref
    torch.cuda.empty_cache()
    if cos < COS_MIN or abs(loss_card - loss_cpu) > LOSS_TOL:
        fail(f"4o gradients vs CPU fp32: cosine {cos}, loss {loss_card} vs "
             f"{loss_cpu}")
    return (f"B=2 gradients of a bigG-width CLIPBind (8 trunk blocks, 4 "
            f"skipped; Lens depth 1) bf16 on the card vs fp32 on the CPU: "
            f"cosine {cos:.6f}, loss {loss_card:.5f} vs {loss_cpu:.5f}, "
            f"grad norm ratio {ratio:.4f} ({time.time() - t0:.1f} s){note}")


def openshape_baselines(torch, np, counters, totals, card, g):
    """The --pc-model baselines at the CLI's widths (scaling 3, 6 channels
    in, 1280 out), fp32: one train step each at B16 (FPS once for
    PointBERT, never for DGCNN and PointNet), the peak memory, a B = 2
    eval forward against the CPU from the same FPS starts and groups
    (BASELINE_TOL by the TF32 setting), the step timed; then a PointNet2
    forward at B16 x 10000 (FPS at both MSG levels). Returns the rates."""
    from vitlens_tpu_torch.models.pc_baselines import PointNet2
    from vitlens_tpu_torch.ops import fps as F
    from vitlens_tpu_torch.train import openshape as OS

    tf32 = torch.backends.cuda.matmul.allow_tf32
    tol = BASELINE_TOL[tf32]
    lines, rates = [], {}
    for name in ("PointBERT", "DGCNN", "PointNet"):
        model = OS.BaselineBind(name, scaling=3, device="cuda")
        model.init_(torch.Generator(device="cuda").manual_seed(SEED))
        tx, opt, step = bind_optimizer(torch, model, trunk=False)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        for b in (OS_B, 8, 4):  # the largest batch that fits (DGCNN's
            # edge features: [B, 10000, 20, 768] fp32 a tensor at scaling 3)
            batch = openshape_batch(torch, g, b)
            torch.cuda.reset_peak_memory_stats()
            try:
                m, counts = run_counted(torch, counters, totals, lambda: step(
                    model, opt, batch, fps_generator=gen))
                break
            except torch.cuda.OutOfMemoryError:
                del batch
                torch.cuda.empty_cache()
                print(f"[4o baselines] {name} train step B{b}: out of device "
                      "memory", flush=True)
        else:
            fail(f"4o {name}: no batch size fits")
        want = launch_counts(fps=1 if name == "PointBERT" else 0)
        if counts != want or not all(np.isfinite(float(v)) for v in m.values()):
            fail(f"4o {name} step: launches {counts} (expected {want}), "
                 f"metrics {m}")
        peak = peak_gb(torch)
        x2 = batch["xyz_features"][:2]
        starts = torch.tensor([17, 4242], dtype=torch.int32) % x2.shape[1]
        ref = copy.deepcopy(model).cpu()
        with torch.no_grad():
            got, want_x, note = shared_knn_groups(
                torch, lambda: model(x2, fps_start=starts.cuda()),
                lambda: ref(x2.cpu(), fps_start=starts),
                sites=[(F, "knn_indices"), (F, "ball_query")])
        err = rel_err(got.cpu(), want_x)
        del ref
        if not (err <= tol and torch.isfinite(got).all()):
            fail(f"4o {name} B=2 vs CPU fp32: rel err {err} > {tol}")
        lines.append(f"{name}: {sum(p.numel() for p in model.parameters())} "
                     f"parameters, B{b} step loss {float(m['loss']):.5f}, "
                     f"launches (fps) {counts['fps']}, peak {peak:.2f} GB, "
                     f"B=2 vs CPU rel err {err:.2e}{note}")
        rates[name] = (b, train_rate(
            torch, card, f"{name} baseline train step B{b} fp32 (scaling 3)",
            lambda: step(model, opt, batch, fps_generator=gen), b))
        del model, opt, tx, step, batch
        torch.cuda.empty_cache()
    net2 = PointNet2(40, device="cuda")
    net2.init_(torch.Generator(device="cuda").manual_seed(SEED))
    x = openshape_batch(torch, g, OS_B)["xyz_features"]
    with torch.no_grad():
        (logp, feat), counts = run_counted(torch, counters, totals,
                                           lambda: net2(x))
    if counts != launch_counts(fps=2) or not torch.isfinite(logp).all() or \
            tuple(feat.shape) != (OS_B, 1024):
        fail(f"4o PointNet2 forward: launches {counts}, shapes "
             f"{tuple(logp.shape)} {tuple(feat.shape)}")
    del net2, x
    torch.cuda.empty_cache()
    print(f"[4o baselines] fp32 (matmul TF32 {tf32}, cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32}; tolerance {tol}) at B{OS_B} x "
          f"10000 points: " + "; ".join(lines) + f"; PointNet2 (40 classes) "
          f"forward B{OS_B}: 2 FPS launches", flush=True)
    return rates


def point_transformer_phase(torch, np, counters, totals, card, g):
    """The PointBERT classifier (PointTransformerConfig(): 8192 points, 512
    groups of 32, width 384, 12 blocks of 6 heads) in bf16 eval: B8 with 1
    FPS, 1 point encoder, 12 kernel 1 and 12 kernel 2 launches, cosine >=
    COS_MIN against fp32 on the CPU given the card's kNN groups; the B64
    encode timed. Returns its rate."""
    from vitlens_tpu_torch.factory import cast_matmul_weights_
    from vitlens_tpu_torch.models.point_transformer import (
        PointTransformer, PointTransformerConfig)

    cfg = PointTransformerConfig()
    model = PointTransformer(cfg, device="cuda")
    model.init_(torch.Generator(device="cuda").manual_seed(SEED))
    ref = copy.deepcopy(model).cpu()
    cast_matmul_weights_(model, torch.bfloat16)
    x = (torch.randn(8, cfg.point.npoints, 3, generator=g, device="cuda")
         * 0.3).bfloat16().float()
    want = launch_counts(fps=1, point_encoder=1, fused_mlp=cfg.depth,
                         flash_attention=cfg.depth)
    with torch.no_grad():
        (emb, counts), want_x, note = shared_knn_groups(
            torch, lambda: run_counted(torch, counters, totals, lambda: model(
                x, compute_dtype=torch.bfloat16)),
            lambda: ref(x.cpu()))
    if counts != want:
        fail(f"4o PointTransformer: launches {counts}, expected {want}")
    cos = cos_min(torch, emb, want_x)
    if cos < COS_MIN:
        fail(f"4o PointTransformer bf16 vs CPU fp32: cosine {cos}")
    print(f"[4o point transformer] B8 x {cfg.point.npoints} points bf16 eval: "
          f"launches (fps, encoder, mlp, attn) {counts['fps']}, "
          f"{counts['point_encoder']}, {counts['fused_mlp']}, "
          f"{counts['flash_attention']}; cosine vs CPU fp32 {cos:.6f}{note}",
          flush=True)
    del ref
    x64 = torch.randn(B, cfg.point.npoints, 3, generator=g, device="cuda") * 0.3

    def encode():
        with torch.no_grad():
            return model(x64, compute_dtype=torch.bfloat16)

    rate = encode_rate(torch, card, f"PointTransformer encode B{B} x "
                       f"{cfg.point.npoints} points bf16", encode, B,
                       dim=tuple(emb.shape)[1])
    del model
    torch.cuda.empty_cache()
    return rate


def write_openshape_inputs(np, root, n_objects):
    """Triplet blobs as OpenShape stores them (xyz, rgb for every other one,
    text_feat [1, 1280], img_feat [1280]; 9000 to 12000 points, so the
    dataset both resamples and subsamples), 8 eval objects of 4 classes and
    their per-class text embeddings."""
    rng = np.random.RandomState(SEED + 14)
    for split, n in (("train", n_objects), ("eval", 8)):
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            pts = 9000 + 1000 * (i % 4)
            blob = {"xyz": (rng.randn(pts, 3) * 0.4).astype(np.float32),
                    "text_feat": rng.randn(1, 1280).astype(np.float32),
                    "img_feat": rng.randn(1280).astype(np.float32)}
            if i % 2:
                blob["rgb"] = rng.rand(pts, 3).astype(np.float32)
            np.save(os.path.join(root, split, f"obj{i:03d}.npy"), blob)
    np.save(os.path.join(root, "cls_feats.npy"),
            rng.randn(4, 1280).astype(np.float32))
    np.save(os.path.join(root, "labels.npy"), np.arange(8) % 4)


def openshape_cli_phase(torch, np, counters, totals, card):
    """`python -m vitlens_tpu_torch.cli.train_openshape` at full vitlensG
    width, in this process, from OS_CLI_OBJECTS fixture triplets at
    --batch-size 16: (a) --epochs 1 with eval, (b) --resume latest --epochs
    2 (starts at epoch 1 with the file's weights; the optimizer's count
    restarts), (c) eval-only from epoch_latest. Launches per run derived
    from the config; checkpoints, meta.json epochs and the eval keys
    checked; the free disk before and the bytes written printed; the
    directory deleted after. Returns the CLI's step seconds."""
    import tempfile

    from vitlens_tpu_torch.cli import train_openshape as CLI
    from vitlens_tpu_torch.train import checkpoint as C
    from vitlens_tpu_torch.train.openshape import vitlensG_tower_config

    root = tempfile.mkdtemp(prefix="vitlens_4o_")
    free_gb = shutil.disk_usage(root).free / 1e9
    if free_gb < OS_DISK_GB:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"4o CLI: {free_gb:.1f} GB free under {root}, the runs write "
             f"~{OS_DISK_GB} GB of checkpoints")
    try:
        write_openshape_inputs(np, root, OS_CLI_OBJECTS)
        logs = os.path.join(root, "logs")
        ev = ["--eval-feats", os.path.join(root, "cls_feats.npy"),
              "--eval-labels", os.path.join(root, "labels.npy"),
              "--eval-files", os.path.join(root, "eval", "*.npy")]
        base = ["--batch-size", str(OS_B), "--log-every-n-steps", "1",
                "--name", "run", "--warmup", "2"]
        train = ["--train-files", os.path.join(root, "train", "*.npy")]
        cfg = vitlensG_tower_config()
        steps = OS_CLI_OBJECTS // OS_B
        per_train = {k: steps * v for k, v in openshape_launches(cfg, True).items()}
        per_eval = openshape_launches(cfg, False)  # 8 eval objects: one batch
        want_ab = {k: per_train[k] + per_eval[k] for k in per_train}
        ckpt = os.path.join(logs, "run", "checkpoints")
        times = {}
        t = time.time()
        rc, counts = run_counted(torch, counters, totals, lambda: CLI.main(
            base + train + ["--logs", logs, "--epochs", "1"] + ev))
        times["a"] = time.time() - t
        if rc != 0 or counts != want_ab:
            fail(f"4o CLI run (a): rc {rc}, launches {counts}, expected {want_ab}")
        if sorted(os.listdir(ckpt)) != ["epoch_1", "epoch_latest"] or \
                C.load_meta(os.path.join(ckpt, "epoch_1"))["epoch"] != 1:
            fail(f"4o CLI run (a): checkpoints {sorted(os.listdir(ckpt))}")
        seen = {}
        build = CLI.build_optimizer

        def spy(args, model, total_steps, mesh=None):  # the weights the resumed run starts from
            saved = torch.load(os.path.join(ckpt, "epoch_latest", C.TREE_FILE),
                               map_location="cpu", weights_only=True)
            seen["equal"] = all(
                torch.equal(p.detach().cpu(), saved["params"][n])
                for n, p in model.named_parameters()) and all(
                torch.equal(b.cpu(), saved["state"][n])
                for n, b in model.named_buffers())
            del saved
            out = build(args, model, total_steps, mesh)
            seen["opt"] = out[1]
            return out

        CLI.build_optimizer = spy
        try:
            t = time.time()
            rc, counts = run_counted(torch, counters, totals, lambda: CLI.main(
                base + train + ["--logs", logs, "--epochs", "2", "--resume",
                                "latest"] + ev))
            times["b"] = time.time() - t
        finally:
            CLI.build_optimizer = build
        if rc != 0 or counts != want_ab or not seen.get("equal") or \
                seen["opt"]["count"] != steps:
            fail(f"4o CLI run (b): rc {rc}, launches {counts}, weights equal "
                 f"the file's {seen.get('equal')}, optimizer count "
                 f"{seen.get('opt', {}).get('count')}")
        if C.load_meta(os.path.join(ckpt, "epoch_latest"))["epoch"] != 2:
            fail("4o CLI run (b): epoch_latest is not epoch 2")
        with open(os.path.join(logs, "run", "results.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        train_steps = [r["step"] for r in recs if "train/loss" in r]
        vals = [r for r in recs if "val/top1" in r]
        if train_steps != list(range(1, 2 * steps + 1)) or len(vals) != 2 or \
                not all({"val/top3", "val/top5", "val/class_top1"} <= set(r)
                        for r in vals):
            fail(f"4o CLI: train steps {train_steps}, val records {vals}")
        written = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(ckpt) for f in fs)
        t = time.time()
        rc, counts = run_counted(torch, counters, totals, lambda: CLI.main(
            base + ["--logs", os.path.join(root, "eval_logs"),
                    "--resume", os.path.join(ckpt, "epoch_latest")] + ev))
        times["c"] = time.time() - t
        with open(os.path.join(root, "eval_logs", "run", "results.jsonl")) as f:
            ev_recs = [json.loads(line) for line in f]
        if rc != 0 or counts != per_eval or len(ev_recs) != 1:
            fail(f"4o CLI run (c): rc {rc}, launches {counts}, records {ev_recs}")
        step_s = [OS_B / r["train/samples_per_s"] for r in recs
                  if "train/samples_per_s" in r]
        print(f"[4o CLI] python -m vitlens_tpu_torch.cli.train_openshape at "
              f"full vitlensG width, {OS_CLI_OBJECTS} triplets, --batch-size "
              f"{OS_B}: {free_gb:.1f} GB free before; run (a) 1 epoch "
              f"{times['a']:.1f} s, (b) --resume latest to epoch 2 "
              f"{times['b']:.1f} s (started at epoch 1 from the file's "
              f"weights, optimizer count restarted: {seen['opt']['count']} "
              f"after its {steps} steps), (c) eval-only {times['c']:.1f} s; "
              f"launches (a), (b) {want_ab['fused_mlp_save_preact']} "
              f"save-preact + {want_ab['fused_mlp']} plain kernel 1, "
              f"{want_ab['flash_attention']} kernel 2, {want_ab['fps']} FPS; "
              f"losses {[round(r['train/loss'], 4) for r in recs if 'train/loss' in r]}; "
              f"eval {[{k[4:]: round(v, 3) for k, v in r.items() if k != 'step'} for r in vals]}, "
              f"eval-only {ev_recs[0]}; checkpoints {sorted(os.listdir(ckpt))}, "
              f"{written / 1e9:.2f} GB written", flush=True)
        print(f"[5 timing] {card} | OpenShape CLI step B{OS_B} (host clock "
              f"between logged steps, the loader and prefetcher included): "
              f"{[round(s, 4) for s in step_s]} s", flush=True)
        return {"cli_step_s": min(step_s)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# -- ROADMAP Queue 1 item 11: EVA-g, LoRA, the BERT-family text towers, RN50,
# the linear probe, the infer CLI and export ------------------------------------

EVA_LN_EPS = 1e-6
# (label, (M, D, H)) of kernel 1 on the EVA-g trunk (D 1408, H 6144, eps 1e-6)
EVA_MLP = (("EVA-g trunk B16", (16 * 257, 1408, 6144)),
           ("EVA-g trunk B64", (64 * 257, 1408, 6144)))
# (label, (B, H, NQ, NK, Dh)) of kernel 2 on this slice's paths
ITEM11_ATTN = (("EVA-g trunk", (64, 16, 257, 257, 88)),
               ("Perceiver-EVA self", (64, 22, 256, 256, 64)),
               ("Perceiver-EVA cross", (64, 1, 256, 512, 64)),
               ("RN50 attention pool", (64, 32, 50, 50, 64)))
EVA_B = (16, 64)
LORA_RANK = 8
LORA_STEPS = 3
LORA_B_STD = 2e-3  # the b's before the B = 2 comparison: scale * a @ b ~ 2e-3


def attach_lora_(torch, model, mask, towers=("visual",)):
    """Phase 4l's LoRA recipe on ``model`` (a TriModel) for the sharded
    phases (4fs, 4tp, 4pp (c)): rank-LORA_RANK factors on the four targets
    of each of ``towers``' trunks, drawn as cli.train draws them (SEED + 17
    + i), each b then drawn N(0, LORA_B_STD) (SEED + 19) so that the merged
    weights differ from the base ones; ``mask`` (tri_model_mask's) updated
    so that those towers train their factors alone. Returns the mask in the
    model's parameter order."""
    from vitlens_tpu_torch.factory import make_generator
    from vitlens_tpu_torch.train.lora import lora_init, lora_mask

    g_b = make_generator(SEED + 19, "cuda")
    for i, t in enumerate(towers):
        tower = getattr(model, t)
        lora_init(tower, LORA_RANK, make_generator(SEED + 17 + i, "cuda"))
        mask.update({f"{t}.{k}": v for k, v in lora_mask(tower).items()})
        with torch.no_grad():
            for n, p in tower.lora.named_parameters():
                if n.endswith(".b"):
                    p.normal_(0.0, LORA_B_STD, generator=g_b)
    return {n: mask[n] for n, _ in model.named_parameters()}
LP_IMAGES = 16  # tactile frames the linear probe trains on (2 steps an epoch at B8)


def check_item11_kernels(torch, g, err, checks):
    """Phase 3's shapes of this slice: kernel 1 at EVA-g's D 1408 / H 6144
    with eps 1e-6 (both variants), kernel 2 at the EVA trunk's head dim 88,
    the Perceiver-EVA self block's 22 heads and the RN50 pool."""
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)
    from vitlens_tpu_torch.ops.fused_mlp import (fused_mlp, fused_mlp_reference,
                                                 fused_mlp_save_preact)

    for label, (m, d, h) in EVA_MLP:
        a = mlp_inputs(torch, g, m, d, h)
        got = fused_mlp(*a, eps=EVA_LN_EPS)
        got2, pre = fused_mlp_save_preact(*a, eps=EVA_LN_EPS)
        torch.cuda.synchronize()
        want, want_pre = fused_mlp_reference(*a, eps=EVA_LN_EPS, save_preact=True)
        e, e2, e_pre = rel_err(got, want), rel_err(got2, want), rel_err(pre, want_pre)
        err["fused_mlp"] = max(err["fused_mlp"], abs_err(got, want),
                               abs_err(got2, want), abs_err(pre, want_pre))
        checks.append(f"mlp{m}x{d}x{h}/eps1e-6={e:.2e},preact out {e2:.2e},a {e_pre:.2e}")
        if not (torch.isfinite(got).all() and max(e, e2) <= MLP_TOL
                and e_pre <= PREACT_TOL):
            fail(f"fused_mlp {label} eps 1e-6: rel err {e}, {e2}, a {e_pre}")
        del a, got, got2, pre, want, want_pre
    for label, (b, h, nq, nk, dh) in ITEM11_ATTN:
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk, dh)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v)
        e = rel_err(got, want)
        err["flash_attention"] = max(err["flash_attention"], abs_err(got, want))
        checks.append(f"attn{b}x{h}x{nq}x{nk}x{dh}={e:.2e}")
        if not (torch.isfinite(got).all() and e <= ATTN_TOL):
            fail(f"flash_attention {label} [{b},{h},{nq},{nk},{dh}]: rel err {e}")
        del q, k, v, got, want


def item11_grad_checks(torch, g):
    """Phase 3's gradient checks of this slice: kernel 1 at EVA-g's widths
    with eps 1e-6 (B16 x 257 rows), kernel 2 at the EVA trunk's head dim 88."""
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)
    from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

    def mlp(*a):
        return fused_mlp(*a, eps=EVA_LN_EPS)

    def mlp_plain(*a):
        return fused_mlp_reference(*a, eps=EVA_LN_EPS)

    m, d, h = EVA_MLP[0][1]
    return {
        f"fused_mlp M{m} {d}->{h} eps 1e-6 gelu": (
            mlp, mlp_plain, mlp_inputs(torch, g, m, d, h), GRAD_TOL,
            ("dx", "dlnw", "dlnb", "dw1", "db1", "dw2", "db2")),
        "attention EVA-g trunk [4,16,257,257,88]": (
            flash_attention, attention_reference,
            qkv_inputs(torch, g, 4, 16, 257, 257, 88), ATTN_GRAD_TOL,
            ("dq", "dk", "dv"))}


def time_item11_kernels(torch, g, timings):
    """Phase 5's rows of this slice's shapes: kernel 1 at EVA-g's B64 trunk
    (with cuBLAS's two products beside it), kernel 2 at the EVA trunk, the
    Perceiver-EVA blocks and the RN50 pool (SDPA beside it)."""
    from vitlens_tpu_torch.ops.attention import plain_attention
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)
    from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

    sdpa = torch.nn.functional.scaled_dot_product_attention
    label, (m, d, h) = EVA_MLP[1]
    a = mlp_inputs(torch, g, m, d, h)
    k_ms, p_ms = paired_ms(lambda: fused_mlp(*a, eps=EVA_LN_EPS),
                           lambda: fused_mlp_reference(*a, eps=EVA_LN_EPS))
    bd, by = mlp_bound(m, d, h)
    x, lnw, lnb, w1, b1, w2, b2 = a
    y = torch.nn.functional.layer_norm(x.float(), (d,), lnw, lnb, EVA_LN_EPS).bfloat16()
    hid = torch.empty(m, h, dtype=torch.bfloat16, device="cuda")
    b1h, b2h = b1.bfloat16(), b2.bfloat16()
    gemm_ms = cuda_ms(lambda: (torch.addmm(b1h, y, w1, out=hid),
                               torch.addmm(b2h, hid, w2)))
    timings["fused_mlp"].append(
        {"shape": f"{label} M={m} D={d} H={h} eps 1e-6", "ms": k_ms,
         "plain_ms": p_ms, "gemm_only_ms": gemm_ms, "bound_ms": bd,
         "bound_by": by, "library_ms": None, "tflops": 4 * m * d * h / k_ms / 1e9})
    del a, x, y, hid
    for label, (b, h, nq, nk, dh) in ITEM11_ATTN:
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk, dh)
        k_ms, p_ms = paired_ms(lambda: flash_attention(q, k, v),
                               lambda: attention_reference(q, k, v))
        bd, by = attn_bound(b, h, nq, nk, dh)
        timings["flash_attention"].append(
            {"shape": f"{label} [{b},{h},{nq},{nk},{dh}]", "ms": k_ms,
             "device_ms": device_ms(torch, lambda: flash_attention(q, k, v)),
             "plain_ms": p_ms,
             "plain_bf16_ms": cuda_ms(lambda: plain_attention(q, k, v, None, dh ** -0.5)),
             "bound_ms": bd, "bound_by": by,
             "library_ms": cuda_ms(lambda: sdpa(q, k, v))})
        del q, k, v


def eva_phase(torch, np, counters, totals, card):
    """Phase 4ev: the Perceiver-EVA pc tower (vitlensG's MLLM plug-in) at
    full width and depth: PointBERT over 8192 points, a Perceiver of depth 4
    (256 latents of 1408), 39 EVA blocks (1408, 16 heads of 88, MLP 6144,
    LayerNorm eps 1e-6), the head to 1024; random weights from a seeded CUDA
    generator, bf16. B16 and B64 encodes with launches tower_launches(cfg);
    a B = 2 encode against the same weights in fp32 on the CPU (the clouds
    rounded through bf16, the card's kNN groups replayed); rates, peak
    memory and a profile. Returns {B: samples/s}."""
    from vitlens_tpu_torch.models.eva import make_eva_tower

    t0 = time.time()
    torch.cuda.empty_cache()
    tower = make_eva_tower("pc", device="cuda", seed=SEED, dtype=torch.bfloat16)
    build_s = time.time() - t0
    cfg = tower.cfg
    n_trunk = sum(p.numel() for p in tower.eva.trunk.parameters())
    n_all = sum(p.numel() for p in tower.parameters())
    want = tower_launches(cfg, fps=1, point_encoder=1)
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    npts = cfg.point.npoints

    def clouds(b):  # rounded through bf16, so the CPU sees what the card sees
        return (torch.randn(b, npts, 3, generator=g, device="cuda") * 0.3
                ).bfloat16().float()

    per_b = []
    with torch.no_grad():
        for b in EVA_B:
            xb = clouds(b)
            emb, counts = run_counted(torch, counters, totals,
                                      lambda: tower(xb, torch.bfloat16))
            if counts != want:
                fail(f"4ev EVA-g B{b}: launches {counts}, expected {want}")
            if tuple(emb.shape) != (b, 1024) or not torch.isfinite(emb).all():
                fail(f"4ev EVA-g B{b}: shape {tuple(emb.shape)} or non-finite")
            per_b.append((b, tuple(counts[k] for k in (
                "fused_mlp", "flash_attention", "fps", "point_encoder"))))
            del xb, emb
        x2 = clouds(2)
        t1 = time.time()
        ref = copy.deepcopy(tower).to(device="cpu", dtype=torch.float32)
        (card2, _), cpu2, note = shared_knn_groups(
            torch, lambda: run_counted(torch, counters, totals,
                                       lambda: tower(x2, torch.bfloat16)),
            lambda: ref(x2.cpu()))
        cpu_s = time.time() - t1
        del ref
    cos = cos_min(torch, card2, cpu2)
    if cos < COS_MIN:
        fail(f"4ev EVA-g B=2 vs CPU fp32: cosine {cos} < {COS_MIN}")
    torch.cuda.reset_peak_memory_stats()
    rates = {}
    for b in EVA_B:
        xb = clouds(b)
        rates[b] = encode_rate(
            torch, card, f"EVA-g (Perceiver-EVA) pc encode B{b} x {npts} points "
            "bf16", lambda: tower(xb, torch.bfloat16), b, dim=1024)
    x64 = clouds(64)
    profile_encode(torch, card, "B64 EVA-g pc encode",
                   lambda: tower(x64, torch.bfloat16))
    print(f"[4ev eva-g] {card} | Perceiver-EVA pc tower at full width and "
          f"depth ({n_all / 1e9:.3f} B parameters, trunk {n_trunk / 1e9:.3f} B; "
          f"built in {build_s:.1f} s): launches (B, (mlp, attn, fps, encoder)) "
          f"{per_b}, expected {tuple(want[k] for k in ('fused_mlp', 'flash_attention', 'fps', 'point_encoder'))}; "
          f"B=2 cosine vs CPU fp32 {cos:.6f} (CPU run {cpu_s:.1f} s){note}; "
          f"rates B16 {rates[16]:.2f}, B64 {rates[64]:.2f} samples/s; peak "
          f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase "
          f"took {time.time() - t0:.1f} s", flush=True)
    del tower
    torch.cuda.empty_cache()
    return rates


def lora_phase(torch, np, counters, totals, card):
    """Phase 4l: the trainer's LoRA recipe on the vitlensL audio tower at
    full width and depth (rank 8, the four targets, the factors alone
    trained: the LoRA mask overrides the tower's lock flags), dual loss
    aligned to text, bf16 compute, fp32 masters. The b's are drawn nonzero
    first, so that the merged weights differ from the base ones. One B = 2
    gradient pass and one B = 2 step against the same model in fp32 on the
    CPU: loss within LOSS_TOL, the cosine of the a's and of the b's
    gradients >= COS_MIN, the step's grad_norm within NORM_TOL (the cosine
    of each factor's change in the step is printed: Adam's first step is
    about lr * sign(g), so it measures the signs of near-zero gradients, not
    the merge). Then 3 steps at B = 8 with the launches of train_launches;
    every base weight bit-equal after, every factor moved. Then the tower in
    a ViTLens: export_checkpoint carries merged weights (no lora.* name)
    whose change from the base weights is scale * a @ b, computed here
    apart from the port's merge; a second model with its own factors
    reloads it (its b's zeroed) to the same encode, and quant refuses the
    unmerged tower."""
    import copy
    import tempfile
    from dataclasses import replace

    from vitlens_tpu_torch import quant
    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.factory import (create_model, make_generator,
                                           make_trainable_)
    from vitlens_tpu_torch.models.lora import Factors
    from vitlens_tpu_torch.train.freeze import tri_model_mask
    from vitlens_tpu_torch.train.lora import lora_init
    from vitlens_tpu_torch.train.losses import make_loss_fn
    from vitlens_tpu_torch.train.step import (OptimizerConfig, StepConfig,
                                              init_train_state, make_optimizer,
                                              make_train_step, micro_grads)

    t0 = time.time()
    torch.cuda.empty_cache()
    model = create_model("ViT-L-14", "audio", seed=SEED, device="cuda",
                         dtype=torch.float32)
    cfg = model.cfg
    acfg, n_text = cfg.tower, cfg.text.layers
    mask = attach_lora_(torch, model, tri_model_mask(
        model, cfg, lock_visual=True, lock_text=True))
    tx, mask = make_optimizer(model, OptimizerConfig(lr=1e-3, warmup=1,
                                                     total_steps=10), mask)
    make_trainable_(model, mask, torch.bfloat16)
    factors = [n for n, t in mask.items() if t and ".lora." in n]
    base0 = {n: p.detach().clone() for n, p in model.named_parameters()
             if not mask[n]}
    fac0 = {n: p.detach().clone() for n, p in model.named_parameters()
            if n in factors}
    sc = StepConfig(n_tower=2, align_to="text", compute_dtype=torch.bfloat16)
    sc_cpu = replace(sc, compute_dtype=torch.float32)
    state = init_train_state(model, tx)
    step = make_train_step(cfg, tx, mask, sc)
    rng = np.random.RandomState(SEED + 21)

    def batch(b):
        text = rng.randint(1, 49000, size=(b, 77))
        text[:, 0], text[:, -1] = 49406, 49407
        fb = rng.randn(b, acfg.audio.target_length, acfg.audio.mel_bins) * 0.5
        return {"text": torch.from_numpy(text).long(),
                "visual": torch.from_numpy(fb.astype(np.float32))}

    want = train_launches(acfg, n_text, 1, False, False)

    # -- B = 2 against the same model in fp32 on the CPU ---------------------
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    a_names = [n for n in factors if n.endswith(".a")]
    b_names = [n for n in factors if n.endswith(".b")]
    loss_fn = make_loss_fn(2)

    def grads_of(m, step_cfg, bt):
        params = {n: p for n, p in m.named_parameters() if mask[n]}
        dev = m.logit_scale.device
        loss, gr = micro_grads(m, {k: v.to(dev) for k, v in bt.items()},
                               step_cfg, params, loss_fn)
        return float(loss), {n: gr[n].detach().double().cpu() for n in factors}

    def cosine(x, y, names):  # in float64, over the named tensors together
        x = torch.cat([x[n].double().flatten().cpu() for n in names])
        y = torch.cat([y[n].double().flatten().cpu() for n in names])
        return (x @ y / (x.norm() * y.norm())).item()

    b2 = batch(2)
    loss_cpu, g_cpu = grads_of(ref, sc_cpu, b2)
    (loss_card, g_card), counts = run_counted(
        torch, counters, totals, lambda: grads_of(model, sc, b2))
    if counts != want:
        fail(f"4l LoRA B=2 gradients: launches {counts}, expected {want}")
    cos_ga, cos_gb = cosine(g_card, g_cpu, a_names), cosine(g_card, g_cpu, b_names)
    if not (abs(loss_card - loss_cpu) <= LOSS_TOL and min(cos_ga, cos_gb) >= COS_MIN):
        fail(f"4l LoRA B=2 gradients vs CPU fp32: loss {loss_card} vs {loss_cpu}, "
             f"cosine a {cos_ga}, b {cos_gb}")
    del g_card, g_cpu
    state_cpu = init_train_state(ref, tx)
    state_cpu, m_cpu = make_train_step(cfg, tx, mask, sc_cpu)(state_cpu, b2)
    (state, m_card), counts = run_counted(torch, counters, totals,
                                          lambda: step(state, b2))
    if counts != want:
        fail(f"4l LoRA B=2 step: launches {counts}, expected {want}")
    m_card = {k: float(v) for k, v in m_card.items()}
    m_cpu = {k: float(v) for k, v in m_cpu.items()}
    if (abs(m_card["loss"] - m_cpu["loss"]) > LOSS_TOL
            or abs(m_card["grad_norm"] / m_cpu["grad_norm"] - 1) > NORM_TOL):
        fail(f"4l LoRA B=2 step vs CPU fp32: card {m_card}, CPU {m_cpu}")
    live = dict(model.named_parameters())
    live_cpu = dict(ref.named_parameters())
    d_card = {n: live[n].detach() - fac0[n] for n in factors}
    d_cpu = {n: live_cpu[n].detach() - fac0[n].cpu() for n in factors}
    cos_da, cos_db = cosine(d_card, d_cpu, a_names), cosine(d_card, d_cpu, b_names)
    del ref, state_cpu, live, live_cpu, d_card, d_cpu
    b2_line = (f"B=2 vs CPU fp32 (b's drawn N(0, {LORA_B_STD})): loss "
               f"{loss_card:.5f} vs {loss_cpu:.5f}, gradient cosine a "
               f"{cos_ga:.6f}, b {cos_gb:.6f}; one step: loss "
               f"{m_card['loss']:.5f} vs {m_cpu['loss']:.5f}, grad_norm "
               f"{m_card['grad_norm']:.5f} vs {m_cpu['grad_norm']:.5f}, cosine "
               f"of the change a {cos_da:.6f}, b {cos_db:.6f} (not gated)")

    steps, step_s = [], []
    for _ in range(LORA_STEPS):
        bt = batch(8)
        t1 = time.perf_counter()
        (state, m), counts = run_counted(torch, counters, totals,
                                         lambda: step(state, bt))
        step_s.append(round(time.perf_counter() - t1, 4))
        if counts != want:
            fail(f"4l LoRA step: launches {counts}, expected {want}")
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"4l LoRA step: metrics {m}")
        steps.append(round(m["loss"], 5))
    moved = [n for n, p in model.named_parameters() if n in base0
             and not torch.equal(p, base0[n])]
    still = [n for n in factors if torch.equal(dict(model.named_parameters())[n],
                                               fac0[n])]
    if moved or still:
        fail(f"4l LoRA: base weights that changed {moved[:5]}, factors that did "
             f"not {still[:5]}")
    n_fac = sum(fac0[n].numel() for n in factors)
    del base0, fac0, state, step

    # the tower served, exported merged, reloaded
    vl = ViTLens("vitlensL", ("audio",), device="cuda", seed=SEED,
                 compute_dtype=torch.bfloat16)
    lora_init(vl.towers["audio"], LORA_RANK, make_generator(SEED, "cuda"))
    vl.towers["audio"].load_state_dict(model.visual.state_dict())
    del model
    fb = torch.from_numpy((rng.randn(2, acfg.audio.target_length,
                                     acfg.audio.mel_bins) * 0.5).astype(np.float32)).cuda()
    e1, counts = run_counted(torch, counters, totals, lambda: vl.encode(
        {"audio": fb}, preprocessed=True)["audio"])
    if counts != tower_launches(acfg):
        fail(f"4l LoRA encode: launches {counts}, expected {tower_launches(acfg)}")
    try:
        quant.quantize_model(vl, towers=("towers.audio",))
        fail("4l: quant.quantize_model took an unmerged LoRA tower")
    except ValueError:
        pass
    root = tempfile.mkdtemp(prefix="vitlens_4l_")
    try:
        path = vl.export_checkpoint(os.path.join(root, "export"))
        saved = torch.load(os.path.join(path, "tree.pt"), map_location="cpu",
                           weights_only=True)["params"]["audio"]
        if any(n.startswith("lora.") for n in saved):
            fail("4l: the exported checkpoint holds LoRA factors")
        # the export's change from the base weights against scale * a @ b,
        # computed here in fp32 apart from the port's merge
        tower = vl.towers["audio"]
        live = dict(tower.named_parameters())
        scale = float(tower.lora.scale)
        got_d, want_d = [], []
        for w, f in tower.lora.named_modules():
            if not isinstance(f, Factors):
                continue
            # w is trunk.blocks.<i>.<target path>: the weight's own name
            got_d.append((saved[w].float() - live[w].detach().float().cpu()).flatten())
            want_d.append((scale * (f.a.detach().float() @ f.b.detach().float()))
                          .cpu().flatten())
        got_d, want_d = torch.cat(got_d).double(), torch.cat(want_d).double()
        cos_m = (got_d @ want_d / (got_d.norm() * want_d.norm())).item()
        ratio_m = (got_d.norm() / want_d.norm()).item()
        if not (len(want_d) and cos_m >= COS_MIN and abs(ratio_m - 1) <= NORM_TOL):
            fail(f"4l: the export's merged weights: cosine {cos_m}, norm ratio "
                 f"{ratio_m} against base + scale * a @ b")
        del got_d, want_d, live
        vl2 = ViTLens("vitlensL", ("audio",), device="cuda", seed=SEED + 1,
                      compute_dtype=torch.bfloat16)
        lora_init(vl2.towers["audio"], LORA_RANK, make_generator(SEED + 2, "cuda"))
        vl2.load_checkpoint(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    zeroed = all(p.abs().max().item() == 0 for n, p in
                 vl2.towers["audio"].lora.named_parameters() if n.endswith(".b"))
    e2 = vl2.encode({"audio": fb}, preprocessed=True)["audio"]
    d = (e1.float() - e2.float()).abs().max().item()
    cos = cos_min(torch, e1, e2)
    if not zeroed or cos < 0.9999:
        fail(f"4l: reload of the merged export: b's zeroed {zeroed}, cosine {cos}")
    print(f"[4l lora] {card} | vitlensL audio+text, LoRA rank {LORA_RANK} on the "
          f"four targets of the audio trunk ({n_fac} factor parameters in "
          f"{len(factors)} tensors; logit_scale trains too): {b2_line}; "
          f"{LORA_STEPS} steps "
          f"at B=8, losses {steps}, host-timed seconds {step_s} (the first "
          f"builds the launches), launches a step as train_launches "
          f"({tuple(want[k] for k in ('fused_mlp', 'fused_mlp_save_preact', 'flash_attention'))} "
          f"plain, save-preact, attention); base weights bit-equal, every factor "
          f"moved; the export holds {len(saved)} merged tensors, no factor, "
          f"its change from the base weights against scale * a @ b: cosine "
          f"{cos_m:.6f}, norm ratio {ratio_m:.6f}, and "
          f"reloads (b's zeroed) to the same encode (max |d| {d:.3e}, cosine "
          f"{cos:.6f}); quant refuses the unmerged tower; phase took "
          f"{time.time() - t0:.1f} s", flush=True)
    del vl, vl2
    torch.cuda.empty_cache()


def hf_text_phase(torch, np, counters, totals, card):
    """Phase 4rb: create_model("roberta-ViT-B-32", "image") at full width,
    bf16: the RoBERTa text tower on token ids given directly (the card has
    no HF tokenizer; post-LN with a pad mask, so the plain path: no launch)
    and the ViT-B-32 image tower (quick GELU; 12 fused MLP + 12 attention),
    each against the same weights in fp32 on the CPU by cosine."""
    from vitlens_tpu_torch.config import image_tower_config
    from vitlens_tpu_torch.factory import create_model
    from vitlens_tpu_torch.models import tri

    t0 = time.time()
    model = create_model("roberta-ViT-B-32", "image", seed=SEED, device="cuda",
                         dtype=torch.bfloat16)
    cfg = model.cfg
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    rng = np.random.RandomState(SEED + 30)
    ids = rng.randint(3, cfg.text.vocab_size, size=(4, cfg.text.context_length))
    for i, n in enumerate((77, 40, 12, 5)):  # <s> ... </s>, then pads
        ids[i, 0], ids[i, n - 1], ids[i, n:] = 0, 2, cfg.text.hf_pad_id
    ids = torch.from_numpy(ids).long()
    images = torch.from_numpy(rng.randn(2, 3, 224, 224).astype(np.float32))
    bf = torch.bfloat16
    with torch.no_grad():
        temb, tc = run_counted(torch, counters, totals, lambda: tri.encode_text(
            model, ids.cuda(), normalize=True, compute_dtype=bf))
        iemb, ic = run_counted(torch, counters, totals, lambda: tri.encode_image(
            model, images.cuda(), normalize=True, compute_dtype=bf))
        cos = {"text": cos_min(torch, temb, tri.encode_text(ref, ids, normalize=True)),
               "image": cos_min(torch, iemb, tri.encode_image(ref, images,
                                                              normalize=True))}
    del ref
    want_i = tower_launches(image_tower_config(cfg))
    if tc != launch_counts() or ic != want_i:
        fail(f"4rb: launches text {tc} (expected none), image {ic}, expected {want_i}")
    if min(cos.values()) < COS_MIN or not (torch.isfinite(temb).all()
                                           and torch.isfinite(iemb).all()):
        fail(f"4rb: cosine vs CPU fp32 {cos}")
    ids64 = ids.repeat(16, 1).cuda()
    rate = encode_rate(torch, card, "roberta-ViT-B-32 text encode B64 bf16 "
                       "(RoBERTa-base, plain path)",
                       lambda: tri.encode_text(model, ids64, compute_dtype=bf),
                       64, dim=cfg.embed_dim)
    print(f"[4rb roberta] {card} | roberta-ViT-B-32 at full width, bf16: text "
          f"B=4 (lengths 77, 40, 12, 5) no kernel launch, image B=2 launches "
          f"(mlp, attn) ({ic['fused_mlp']}, {ic['flash_attention']}); cosine vs "
          f"CPU fp32 " + " ".join(f"{k} {v:.6f}" for k, v in cos.items())
          + f"; text B64 {rate:.2f} samples/s; phase took {time.time() - t0:.1f} s",
          flush=True)
    del model
    torch.cuda.empty_cache()


def resnet_phase(torch, np, counters, totals, card):
    """Phase 4r: ModifiedResNet RN50 at 224, bf16 (cuDNN convolutions, the
    attention pool through kernel 2: one launch a forward), against the same
    weights in fp32 on the CPU by cosine; the B64 rate."""
    from vitlens_tpu_torch.models.resnet import make_modified_resnet

    t0 = time.time()
    m = make_modified_resnet("RN50", device="cuda", seed=SEED, dtype=torch.bfloat16)
    ref = copy.deepcopy(m).to(device="cpu", dtype=torch.float32)
    x = torch.from_numpy(np.random.RandomState(SEED + 31).randn(2, 3, 224, 224)
                         .astype(np.float32))
    with torch.no_grad():
        emb, counts = run_counted(torch, counters, totals,
                                  lambda: m(x.cuda(), torch.bfloat16))
        cos = cos_min(torch, emb, ref(x))
    del ref
    if counts != launch_counts(flash_attention=1):
        fail(f"4r RN50: launches {counts}, expected one attention launch")
    if cos < COS_MIN or tuple(emb.shape) != (2, 1024):
        fail(f"4r RN50: cosine vs CPU fp32 {cos}, shape {tuple(emb.shape)}")
    x64 = torch.randn(64, 3, 224, 224, device="cuda")
    with torch.no_grad():
        rate = encode_rate(torch, card, "RN50 image encode B64 bf16",
                           lambda: m(x64, torch.bfloat16), 64, dim=1024)
    print(f"[4r rn50] {card} | ModifiedResNet RN50 at 224, bf16: launches "
          f"(attention) {counts['flash_attention']}; cosine vs CPU fp32 "
          f"{cos:.6f}; B64 {rate:.2f} samples/s; phase took "
          f"{time.time() - t0:.1f} s", flush=True)
    del m
    torch.cuda.empty_cache()


def _module_cli(module, argv, env, log, timeout=900):
    """python -m ``module`` ``argv`` as a child process on the card, its
    stderr into ``log``; -> (exit code, seconds, stdout)."""
    t0 = time.time()
    with open(log, "w") as err:
        p = subprocess.run([sys.executable, "-m", module, *argv],
                           cwd=os.path.dirname(os.path.abspath(__file__)),
                           env=env, stdout=subprocess.PIPE, stderr=err,
                           text=True, timeout=timeout)
    return p.returncode, time.time() - t0, p.stdout


def linprobe_phase(torch, np, card):
    """Phase 4lp: `python -m vitlens_tpu_torch.cli.train_linprobe` as a
    child process on the card: the tactile probe at full ViT-L width
    (random backbone from the seed, bf16), LP_IMAGES written GelSight frames
    at 320 x 240 with rough/smooth labels, B = 8, 2 epochs (4 LARS steps),
    an eval of 8 frames after each; exit 0, an accuracy a val epoch; the
    host-timed step seconds from its log."""
    import re
    import tempfile

    from PIL import Image

    t0 = time.time()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="vitlens_4lp_")
    meta = os.path.join(root, "meta", "modal_tactile", "data")
    os.makedirs(meta)
    rng = np.random.RandomState(SEED + 50)
    anno = []
    for i in range(LP_IMAGES):
        rough = i % 2
        img = rng.randint(0, 255, (240, 320, 3)).astype(np.float64)
        img = img if rough else np.full_like(img, img.mean())  # textured or flat
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(root, f"g{i}.jpg"))
        anno.append({"gel_path": f"g{i}.jpg", "image_path": "", "sr_label": rough})
    for name, rows in (("train_rough.json", anno), ("test_rough.json", anno[:8])):
        with open(os.path.join(meta, name), "w") as f:
            json.dump(rows, f)
    env = dict(os.environ, VITLENS_TACTILE_DATA_DIR=root,
               VITLENS_METADATA_DIR=os.path.join(root, "meta"))
    logs = os.path.join(root, "logs")
    try:
        rc, secs, _ = _module_cli(
            "vitlens_tpu_torch.cli.train_linprobe",
            ["--modality", "tactile", "--model", "ViT-L-14", "--train-split",
             "train_rough", "--val-split", "test_rough", "--num-classes", "2",
             "--batch-size", "8", "--epochs", "2", "--warmup", "1", "--workers",
             "2", "--precision", "bf16", "--log-every-n-steps", "1", "--logs",
             logs, "--name", "lp"], env, os.path.join(root, "lp.log"))
        if rc != 0:
            fail(f"4lp: exit {rc}: {open(os.path.join(root, 'lp.log')).read()[-2000:]}")
        recs = _records(os.path.join(logs, "lp"))
        accs = [r for r in recs if any(k.endswith("accuracy") for k in r)]
        out_log = open(os.path.join(logs, "lp", "out.log")).read()
        step_s = [float(v) for v in re.findall(r"loss [-\d.]+ \(([\d.]+) s\)", out_log)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if len(accs) != 2 or len(step_s) != 4:
        fail(f"4lp: val records {accs}, step times {step_s}")
    print(f"[4lp linprobe] {card} | cli.train_linprobe, tactile probe on ViT-L-14 "
          f"at full width, bf16, B=8, LARS: exit 0 in {secs:.1f} s (the child's "
          f"start and model build included); step seconds (host-timed, the first "
          f"builds the launches) {step_s}; val {accs}; phase took "
          f"{time.time() - t0:.1f} s", flush=True)
    return step_s


def infer_phase(torch, np, card):
    """Phase 4i: `python -m vitlens_tpu_torch.cli.infer --precision bf16` as
    a child process on the card, on written WAV, .npy cloud and PNG files and
    three captions (ViT-L, weights from the seed): its six printed softmax
    matrices have rows summing to 1 and equal those of the API's encode of
    the same files in this process (the same seed and modality order)."""
    import re
    import tempfile

    from PIL import Image

    from tools.reference_layout import pcm_from_float, write_wav
    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.cli.infer import similarity_matrices

    t0 = time.time()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="vitlens_4i_")
    rng = np.random.RandomState(SEED + 60)
    files = {"audio": [], "pc": [], "image": []}
    for i in range(2):
        files["audio"].append(os.path.join(root, f"a{i}.wav"))
        write_wav(files["audio"][-1], pcm_from_float(_tone(np, 16000, 4.0, 1, i), 16),
                  16000)
        files["pc"].append(os.path.join(root, f"c{i}.npy"))
        np.save(files["pc"][-1], (rng.randn(9000, 3) * 0.3).astype(np.float32))
        files["image"].append(os.path.join(root, f"i{i}.png"))
        Image.fromarray(rng.randint(0, 255, (240, 320, 3)).astype(np.uint8)).save(
            files["image"][-1])
    captions = ["a dog barking", "a chair", "waves on rocks"]
    argv = ["--precision", "bf16", "--image", *files["image"], "--audio",
            *files["audio"], "--pc", *files["pc"], "--text", *captions]
    try:
        rc, secs, out = _module_cli("vitlens_tpu_torch.cli.infer", argv,
                                    dict(os.environ), os.path.join(root, "infer.log"))
        if rc != 0:
            fail(f"4i: exit {rc}: {open(os.path.join(root, 'infer.log')).read()[-2000:]}")
        blocks = re.split(r"\n(\w+) x (\w+) softmax\([^)]*\):\n", "\n" + out)
        got = {(a, b): np.asarray([float(v) for v in re.findall(
            r"[-+]?\d*\.\d+(?:e[-+]?\d+)?", body)])
            for a, b, body in zip(blocks[1::3], blocks[2::3], blocks[3::3])}
        vl = ViTLens("vitlensL", ["image", "audio", "pc", "text"], device="cuda",
                     seed=0, compute_dtype=torch.bfloat16)
        emb = vl.encode({"image": files["image"], "audio": files["audio"],
                         "pc": files["pc"], "text": captions})  # the CLI's order
        want = similarity_matrices({m: v.float().cpu().numpy() for m, v in emb.items()},
                                   100.0)
        del vl
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if list(got) != list(want):
        fail(f"4i: printed pairs {list(got)}, expected {list(want)}")
    d = max(np.abs(got[k] - want[k].ravel()).max() for k in want)
    rows = max(np.abs(want[k].sum(-1) - 1).max() for k in want)
    if d > 1e-3 or rows > 1e-9 or any(got[k].size != want[k].size for k in want):
        fail(f"4i: printed matrices differ from the API's by {d}, rows off 1 by {rows}")
    print(f"[4i infer] {card} | cli.infer --precision bf16 on 2 WAV, 2 .npy "
          f"clouds, 2 PNG and 3 captions (ViT-L): exit 0 in {secs:.1f} s; "
          f"{len(got)} matrices {[k for k in got]}, rows summing to 1, max |d| "
          f"{d:.2e} against the API's encode in this process (5 printed "
          f"digits); phase took {time.time() - t0:.1f} s", flush=True)


def export_phase(torch, model, counters, totals, card, fb):
    """Phase 4ex: utils.export.export_encoder of the vitlensL audio tower in
    bf16 on the card (the kernels recorded as custom ops), load_exported,
    then the loaded program on the same B = 2 fbank: the kernels' launch
    counters advance by the tower's counts (tower_launches) and its output
    equals the eager normalised encode. Then :func:`op_overhead_us`."""
    from vitlens_tpu_torch.utils.export import export_encoder, load_exported

    t0 = time.time()
    tower = model.towers["audio"]
    x = fb[:, 0].contiguous()
    blob = export_encoder(tower, x, torch.bfloat16)
    t_export, n_bytes = time.time() - t0, len(blob)
    prog = load_exported(blob)
    ops = {}
    for n in prog.program.graph.nodes:
        if str(n.target).startswith("vitlens."):
            ops[str(n.target)] = ops.get(str(n.target), 0) + 1
    got, counts = run_counted(torch, counters, totals, lambda: prog.call(x))
    want = model.encode({"audio": x}, preprocessed=True)["audio"]
    if counts != tower_launches(tower.cfg):
        fail(f"4ex: the loaded program's launches {counts}, expected "
             f"{tower_launches(tower.cfg)}")
    d = (got.float() - want.float()).abs().max().item()
    if d > 1e-6:
        fail(f"4ex: the loaded program differs from the eager encode by {d}")
    del prog, blob
    over = op_overhead_us(torch)
    print(f"[4ex export] {card} | export_encoder(vitlensL audio tower, bf16) in "
          f"{t_export:.1f} s, {n_bytes / 1e9:.3f} GB, "
          f"ops in the graph {ops}; "
          f"the loaded program launched (mlp, attn) ({counts['fused_mlp']}, "
          f"{counts['flash_attention']}), max |d| vs the eager encode {d:.2e}; "
          f"host-timed us a call, the wrapper's own dispatch vs its custom op, "
          f"at a small shape (launch-bound) {over}; "
          f"phase took {time.time() - t0:.1f} s", flush=True)


COCA_SOT, COCA_EOS = 49406, 49407
COCA_BEAM = dict(num_beams=6, num_beam_groups=3)
COCA_SEQ = 20           # the decoding checks' seq_len
COCA_TIME_SEQ = 30      # the timed beam search's (coca_generate's default)
COCA_MIN_LEN = 5        # coca_generate's min_seq_len
COCA_PROFILE_SEQ = 10   # the profiled beam search's seq_len
COCA_COS_MIN = 0.999    # bf16 card against fp32 CPU: features and logits
COCA_LOSS_TOL = 1e-2    # relative, each of the two loss terms
COCA_MARGIN = 0.05      # a teacher-forced token's logit below the CPU's bar
# kernel 2 at CoCa's shapes: the L-14 pooler (8 heads of 96 over the 257
# trunk tokens, its queries broadcast over the batch), the B-32 pooler (8 of
# 64 over 50) and the decoder's cross blocks (12 heads of 64; NQ 1..76 over
# the 256 image tokens, B x beams rows)
COCA_ATTN = (("CoCa L-14 pooler", (64, 8, 257, 257, 96)),
             ("CoCa L-14 decoder cross", (64, 12, 76, 256, 64)),
             ("CoCa B-32 pooler", (64, 8, 257, 50, 64)))


def check_coca_kernels(torch, g, err, checks):
    """Phase 3's shapes of CoCa: kernel 2 at the pooler's head dim 96 and
    the B-32 pooler's 50 keys, the decoder's cross shapes (NQ in {1, 29, 76}
    by NK in {256, 257} at 12 and 8 heads, on the cross block's q and k/v
    views too, bit-equal to contiguous copies), and a broadcast query (batch
    stride 0, as ``expand`` gives it) refused by the wrapper while its
    contiguous copy runs."""
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)

    worst = 0.0
    cases = [(b, h, nq, nk, dh) for _, (b, h, nq, nk, dh) in COCA_ATTN]
    cases += [(12, h, nq, nk, 64) for h in (12, 8) for nq in (1, 29, 76)
              for nk in (256, 257)]
    for b, h, nq, nk, dh in cases:
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk, dh)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v)
        e = rel_err(got, want)
        worst = max(worst, e)
        err["flash_attention"] = max(err["flash_attention"], abs_err(got, want))
        if not (torch.isfinite(got).all() and e <= ATTN_TOL):
            fail(f"flash_attention CoCa [{b},{h},{nq},{nk},{dh}]: rel err {e}")
    checks.append(f"attn-coca(pooler D96, B-32 pooler, cross NQ 1/29/76 x NK "
                  f"256/257)<={worst:.2e}")
    for nq, nk in ((29, 256), (76, 257)):  # the cross block's views
        b, h, d = 12, 12, 768
        q = torch.randn(b, nq, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, nk, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, nk, d, generator=g, device="cuda").bfloat16()
        q, k, v = (t.view(b, -1, h, 64).transpose(1, 2) for t in (q, k, v))
        got = flash_attention(q, k, v)
        want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"flash_attention on the cross block's views NQ{nq} NK{nk}: "
                 "differs from the call on contiguous copies")
        checks.append(f"attn-cross-views{b}x{h}x{nq}x{nk}=bit-equal")
    q1, k, v = qkv_inputs(torch, g, 1, 8, 257, 257, 96)
    k, v = k.expand(4, -1, -1, -1).contiguous(), v.repeat(4, 1, 1, 1)
    q = q1.expand(4, -1, -1, -1)
    try:
        flash_attention(q, k, v)
        fail("flash_attention took a broadcast (batch stride 0) query")
    except ValueError as e:
        if "broadcast view" not in str(e):
            raise
    got = flash_attention(q.contiguous(), k, v)
    torch.cuda.synchronize()
    e = rel_err(got, attention_reference(q, k, v))
    if not (torch.isfinite(got).all() and e <= ATTN_TOL):
        fail(f"flash_attention on the pooler's contiguous broadcast query: {e}")
    checks.append(f"attn-broadcast-query=refused,contiguous-copy {e:.2e}")


def coca_grad_checks(torch, g):
    """Phase 3's gradient checks of CoCa's kernel-2 shapes: the L-14 pooler
    at head dim 96 and a decoder cross block over 12 beam rows."""
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)

    return {f"attention {label} [{b},{h},{nq},{nk},{dh}]": (
        flash_attention, attention_reference,
        qkv_inputs(torch, g, b, h, nq, nk, dh), ATTN_GRAD_TOL,
        ("dq", "dk", "dv"))
        for label, (b, h, nq, nk, dh) in (("CoCa pooler", (2, 8, 257, 257, 96)),
                                          ("CoCa cross", (12, 12, 76, 256, 64)))}


def time_coca_kernels(torch, g, timings):
    """Phase 5's kernel-2 rows at CoCa's shapes, beside plain, SDPA and the
    bound."""
    from vitlens_tpu_torch.ops.attention import plain_attention
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, (b, h, nq, nk, dh) in COCA_ATTN:
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk, dh)
        k_ms, p_ms = paired_ms(lambda: flash_attention(q, k, v),
                               lambda: attention_reference(q, k, v))
        bd, by = attn_bound(b, h, nq, nk, dh)
        timings["flash_attention"].append(
            {"shape": f"{label} [{b},{h},{nq},{nk},{dh}]", "ms": k_ms,
             "device_ms": device_ms(torch, lambda: flash_attention(q, k, v)),
             "plain_ms": p_ms,
             "plain_bf16_ms": cuda_ms(lambda: plain_attention(q, k, v, None, dh ** -0.5)),
             "bound_ms": bd, "bound_by": by,
             "library_ms": cuda_ms(lambda: sdpa(q, k, v))})
        del q, k, v


def coca_captions(torch, np, rng, lengths, context_length):
    """Token ids [len(lengths), context_length + 1]: SOT, random tokens,
    EOT at each length, then a pad (0) tail."""
    text = np.zeros((len(lengths), context_length + 1), np.int64)
    for i, n in enumerate(lengths):
        text[i, 0], text[i, n - 1] = COCA_SOT, COCA_EOS
        text[i, 1:n - 1] = rng.randint(1, COCA_SOT, n - 2)
    return torch.from_numpy(text)


def coca_tf_logits(torch, model, image_embs, seqs, dtype):
    """Teacher-forced vocab logits [N, L, V] of token buffers [N, L] (the
    decode step's computation over the whole buffer), fp32."""
    with torch.no_grad():
        _, toks = model.encode_text(seqs, dtype)
        return model.text_decoder(image_embs, toks).float()


def coca_ended(seqs, np):
    """Per row: SOT first, and nothing but pad after the first EOS or pad
    (a finished beam hypothesis is stored without its EOS)."""
    for row in seqs.cpu().numpy():
        if row[0] != COCA_SOT:
            return False
        end = np.nonzero((row[1:] == COCA_EOS) | (row[1:] == 0))[0]
        if len(end) and (row[end[0] + 2:] != 0).any():
            return False
    return True


def coca_tf_check(torch, seqs, logits, rank, min_seq_len=COCA_MIN_LEN):
    """Each token t at position p (up to its row's first EOS or pad) against
    the logits at p - 1 with the min-length mask: within COCA_MARGIN of the
    ``rank``-th largest or above. Returns (positions checked, positions
    below the rank-th largest, worst shortfall)."""
    n = below = 0
    worst = 0.0
    for b, row in enumerate(seqs.cpu().tolist()):
        for p in range(1, len(row)):
            t = row[p]
            if t == 0:
                break
            lg = logits[b, p - 1].clone()
            if p < min_seq_len:
                lg[COCA_EOS] = float("-inf")
            bar = torch.topk(lg, rank).values[-1].item()
            short = bar - lg[t].item()
            n += 1
            if short > 0:
                below += 1
                worst = max(worst, short)
            if t == COCA_EOS:
                break
    return n, below, worst


def coca_phase(torch, np, counters, totals, card):
    """Phase 4co: CoCa at full width and depth, seeded weights, bf16 on the
    card against the same weights in fp32 on the CPU. coca_ViT-L-14 (0.64 B
    parameters): a B = 2 encode and forward (cosine of the image and text
    features and the caption logits >= COCA_COS_MIN, the two loss terms
    within COCA_LOSS_TOL relative), launches as coca_launches; a B = 2
    backward of contrastive + caption on fp32 masters (gradient cosine >=
    COS_MIN on the pooler, the decoder's cross blocks and the vision trunk's
    last block); beam search (6 beams, 3 groups, seq_len COCA_SEQ, B = 2)
    twice, identical, SOT first and pad after the end, launches as
    coca_launches; width-1 beam against top_k=1 sampling, equal up to the
    first EOS or the first tie of the card's top logits; the card's tokens
    teacher-forced on the CPU in fp32: each width-1 beam token the CPU's
    argmax or within COCA_MARGIN of its max, each beam-search token within
    COCA_MARGIN of the CPU's top 2 x (beams / groups), the width a beam
    step draws from. coca_ViT-B-32: a B = 2 encode and forward, cosines
    and launches. Then the L-14 image encode at B64, the forward + backward
    at B16 and beam-search captions at B = 8 (seq_len COCA_TIME_SEQ), with
    profiles of the pass and of a shorter captioning. Returns the rates."""
    from vitlens_tpu_torch.models.coca import coca_generate, make_coca
    from vitlens_tpu_torch.train.losses import coca_loss

    t0 = time.time()
    torch.cuda.empty_cache()
    bf = torch.bfloat16
    model = make_coca("coca_ViT-L-14", device="cuda", seed=SEED, dtype=bf)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    rng = np.random.RandomState(SEED + 50)
    # rounded through bf16, so the CPU sees the pixels the card sees
    images = torch.from_numpy(rng.randn(2, 3, 224, 224).astype(np.float32)
                              ).bfloat16().float()
    text = coca_captions(torch, np, rng, (18, 51), cfg.text.context_length)
    im_c, text_c = images.cuda(), text.cuda()
    lines = []
    with torch.no_grad():
        (_, embs_card), n_enc = run_counted(
            torch, counters, totals, lambda: model.encode_image(im_c, bf))
        out, n_fwd = run_counted(torch, counters, totals,
                                 lambda: model(im_c, text_c, bf))
        want = ref(images, text)
    for label, got, exp in (("encode", n_enc, coca_launches(cfg, "encode")),
                            ("forward", n_fwd, coca_launches(cfg, "forward"))):
        if got != exp:
            fail(f"4co L-14 {label}: launches {got}, expected {exp}")
    cos = {k: cos_min(torch, out[k], want[k])
           for k in ("image_features", "text_features", "logits")}
    losses = [(float(a), float(b)) for a, b in zip(coca_loss(out, cfg),
                                                   coca_loss(want, cfg))]
    loss_rel = max(abs(a - b) / abs(b) for a, b in losses)
    if min(cos.values()) < COCA_COS_MIN or loss_rel > COCA_LOSS_TOL:
        fail(f"4co L-14 B=2 vs CPU fp32: cosine {cos}, losses (card, CPU) "
             f"{losses}")
    lines.append(f"L-14 B=2 launches (mlp, attn) encode ({n_enc['fused_mlp']}, "
                 f"{n_enc['flash_attention']}), forward ({n_fwd['fused_mlp']}, "
                 f"{n_fwd['flash_attention']}); cosine vs CPU fp32 "
                 + " ".join(f"{k} {v:.6f}" for k, v in cos.items())
                 + f"; contrastive {losses[0][0]:.5f} vs {losses[0][1]:.5f}, "
                 f"caption {losses[1][0]:.5f} vs {losses[1][1]:.5f}")
    del out, want

    # -- gradients of contrastive + caption on fp32 masters ------------------
    last = f"visual.trunk.blocks.{cfg.vision.layers - 1}."
    groups = {"pooler": "visual.attn_pool.",
              "decoder cross blocks": "text_decoder.cross_attn.",
              "vision trunk last block": last}
    gm = copy.deepcopy(ref).to("cuda")
    for m in (gm, ref):
        for n, p in m.named_parameters():
            p.requires_grad_(n.startswith(tuple(groups.values())))

    def grads(m, dtype, dev):
        params = {n: p for n, p in m.named_parameters() if p.requires_grad}
        c, cap = coca_loss(m(images.to(dev), text.to(dev), dtype), cfg)
        gr = torch.autograd.grad(c + cap, list(params.values()))
        return float((c + cap).detach()), {n: t.detach().double().cpu()
                                for n, t in zip(params, gr)}

    (loss_card, g_card), n_bwd = run_counted(torch, counters, totals,
                                             lambda: grads(gm, bf, "cuda"))
    loss_cpu, g_cpu = grads(ref, torch.float32, "cpu")
    gcos = {}
    for label, prefix in groups.items():
        a = torch.cat([g_card[n].flatten() for n in g_card if n.startswith(prefix)])
        b = torch.cat([g_cpu[n].flatten() for n in g_cpu if n.startswith(prefix)])
        gcos[label] = (a @ b / (a.norm() * b.norm())).item()
    if min(gcos.values()) < COS_MIN or abs(loss_card - loss_cpu) > COCA_LOSS_TOL * abs(loss_cpu):
        fail(f"4co L-14 B=2 gradients vs CPU fp32: loss {loss_card} vs "
             f"{loss_cpu}, cosine {gcos}")
    for p in ref.parameters():
        p.requires_grad_(False)
    lines.append(f"B=2 backward (loss {loss_card:.5f} vs {loss_cpu:.5f}; "
                 f"launches plain, save-preact, attn ({n_bwd['fused_mlp']}, "
                 f"{n_bwd['fused_mlp_save_preact']}, {n_bwd['flash_attention']})) "
                 "gradient cosine " + ", ".join(f"{k} {v:.6f}"
                                                 for k, v in gcos.items()))
    del g_card, g_cpu

    # -- decoding in bf16 ------------------------------------------------------
    kw = dict(seq_len=COCA_SEQ, min_seq_len=COCA_MIN_LEN, compute_dtype=bf)
    beam, n_gen = run_counted(torch, counters, totals, lambda: coca_generate(
        model, im_c, **COCA_BEAM, **kw))
    beam2 = coca_generate(model, im_c, **COCA_BEAM, **kw)
    want_gen = coca_launches(cfg, "generate", steps=COCA_SEQ - 1)
    if n_gen != want_gen:
        fail(f"4co beam search: launches {n_gen}, expected {want_gen}")
    if not torch.equal(beam, beam2) or not coca_ended(beam, np):
        fail(f"4co beam search: runs differ ({torch.equal(beam, beam2)}) or "
             f"rows malformed: {beam.tolist()}")
    beam1 = coca_generate(model, im_c, num_beams=1, num_beam_groups=1, **kw)
    top1 = coca_generate(model, im_c, generation_type="top_k", top_k=1,
                         generator=torch.Generator("cuda").manual_seed(SEED),
                         **kw)
    tf_card = coca_tf_logits(torch, model, embs_card, beam1, bf)
    agree, cut = [], []
    for b_, (r1, rk) in enumerate(zip(beam1.tolist(), top1.tolist())):
        stop = COCA_SEQ - 1  # the sampler forces EOS at the last position
        if COCA_EOS in r1:
            stop = min(stop, r1.index(COCA_EOS))
        for p in range(1, stop):  # a tie at the top: the two may part
            lg = tf_card[b_, p - 1].clone()
            if p < COCA_MIN_LEN:
                lg[COCA_EOS] = float("-inf")
            top2 = torch.topk(lg, 2).values
            if top2[0] == top2[1]:
                stop = p
                cut.append((b_, p))
                break
        agree.append(stop)
        if r1[:stop] != rk[:stop]:
            fail(f"4co width-1 beam vs top_k=1 row {b_}: {r1} vs {rk} "
                 f"(compared up to {stop})")
    # the card's tokens teacher-forced on the CPU in fp32
    with torch.no_grad():
        _, embs_cpu = ref.encode_image(images)
    n1, below1, worst1 = coca_tf_check(torch, beam1, coca_tf_logits(
        torch, ref, embs_cpu, beam1.cpu(), torch.float32), 1)
    width = 2 * COCA_BEAM["num_beams"] // COCA_BEAM["num_beam_groups"]
    nb, belowb, worstb = coca_tf_check(torch, beam, coca_tf_logits(
        torch, ref, embs_cpu, beam.cpu(), torch.float32), width)
    if max(worst1, worstb) > COCA_MARGIN:
        fail(f"4co teacher-forced on the CPU: width-1 beam worst shortfall "
             f"{worst1}, beam search {worstb} > {COCA_MARGIN}")
    lines.append(
        f"beam search (6 beams, 3 groups, seq_len {COCA_SEQ}) launches (mlp, "
        f"attn) ({n_gen['fused_mlp']}, {n_gen['flash_attention']}), two runs "
        f"identical, tokens {beam.tolist()}; width-1 beam = top_k=1 over the "
        f"first {agree} positions (ties cut at {cut}); teacher-forced on the "
        f"CPU fp32: width-1 beam {n1} tokens, {below1} below the CPU's argmax "
        f"(worst {worst1:.4f}), beam search {nb} tokens, {belowb} below the "
        f"CPU's top {width} (worst {worstb:.4f}; margin {COCA_MARGIN})")
    del ref, gm, tf_card

    # -- coca_ViT-B-32 at full width -------------------------------------------
    b32 = make_coca("coca_ViT-B-32", device="cuda", seed=SEED + 1, dtype=bf)
    ref32 = copy.deepcopy(b32).to(device="cpu", dtype=torch.float32)
    with torch.no_grad():
        _, n_enc32 = run_counted(torch, counters, totals,
                                 lambda: b32.encode_image(im_c, bf))
        out32, n_fwd32 = run_counted(torch, counters, totals,
                                     lambda: b32(im_c, text_c, bf))
        want32 = ref32(images, text)
    for label, got, exp in (("encode", n_enc32, coca_launches(b32.cfg, "encode")),
                            ("forward", n_fwd32, coca_launches(b32.cfg, "forward"))):
        if got != exp:
            fail(f"4co B-32 {label}: launches {got}, expected {exp}")
    cos32 = {k: cos_min(torch, out32[k], want32[k])
             for k in ("image_features", "text_features", "logits")}
    if min(cos32.values()) < COCA_COS_MIN:
        fail(f"4co B-32 B=2 vs CPU fp32: cosine {cos32}")
    lines.append(f"B-32 B=2 launches encode ({n_enc32['fused_mlp']}, "
                 f"{n_enc32['flash_attention']}), forward ({n_fwd32['fused_mlp']}, "
                 f"{n_fwd32['flash_attention']}); cosine "
                 + " ".join(f"{k} {v:.6f}" for k, v in cos32.items()))
    del b32, ref32, out32, want32
    check_s = time.time() - t0

    # -- phase 5: rates ------------------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(SEED + 51)
    x64 = torch.randn(64, 3, 224, 224, generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        enc_rate = encode_rate(torch, card, "CoCa L-14 image encode B64 bf16",
                               lambda: model.encode_image(x64, bf)[0], 64)
    del x64
    t_enc = time.time()
    tm = copy.deepcopy(model)
    for p in tm.parameters():  # fp32 masters, every one trained
        p.data = p.data.float()
        p.requires_grad_(True)
    x16 = torch.randn(16, 3, 224, 224, generator=g, device="cuda")
    t16 = coca_captions(torch, np, rng, [int(n) for n in rng.randint(8, 78, 16)],
                        cfg.text.context_length).cuda()
    params = list(tm.parameters())

    def fwd_bwd():
        c, cap = coca_loss(tm(x16, t16, bf), cfg)
        torch.autograd.grad(c + cap, params)

    train_b16 = train_rate(torch, card, "CoCa L-14 forward + backward B16 bf16 "
                           "(fp32 masters, every parameter)", fwd_bwd, 16)
    profile_encode(torch, card, "CoCa L-14 forward + backward B16", fwd_bwd)
    del tm, params, x16, t16
    t_train = time.time()
    x8 = torch.randn(8, 3, 224, 224, generator=g, device="cuda")

    def caption8():
        return coca_generate(model, x8, **COCA_BEAM, seq_len=COCA_TIME_SEQ,
                             compute_dtype=bf)

    caption8()
    runs = []
    for _ in range(3):
        t1 = time.perf_counter()
        caption8()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t1)
    cap_rate = 8 / min(runs)
    print(f"[5 timing] {card} | CoCa L-14 beam-search captions B=8 (6 beams, "
          f"3 groups, seq_len {COCA_TIME_SEQ}) bf16: {cap_rate:.2f} captions/s, "
          f"best of 3: {min(runs) * 1e3:.2f} ms, all ms "
          f"{[round(r * 1e3, 2) for r in runs]}", flush=True)
    # the profile's own cost grows with the events: a shorter decode
    profile_encode(torch, card, f"CoCa L-14 beam-search captions B=8, seq_len "
                   f"{COCA_PROFILE_SEQ}", lambda: coca_generate(
                       model, x8, **COCA_BEAM, seq_len=COCA_PROFILE_SEQ,
                       compute_dtype=bf))
    print(f"[4co coca] {card} | coca_ViT-L-14 at full width and depth "
          f"({n_params / 1e9:.3f} B parameters), bf16 on the card against fp32 "
          f"on the CPU: " + "; ".join(lines)
          + f"; checks took {check_s:.1f} s, the encode rate "
          f"{t_enc - t0 - check_s:.1f}, the forward + backward's "
          f"{t_train - t_enc:.1f}, the captions' {time.time() - t_train:.1f}; "
          f"rates: image encode B64 "
          f"{enc_rate:.2f} samples/s, forward + backward B16 "
          f"{16 / train_b16:.4f} s a pass, captions B=8 {cap_rate:.2f}/s; "
          f"phase took {time.time() - t0:.1f} s", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"encode": enc_rate, "pass_s": 16 / train_b16, "captions": cap_rate}


def op_overhead_us(torch, n=300):
    """{kernel: (wrapper us, custom op us)} a call, host-timed over ``n``
    calls without gradients at a small, launch-bound shape, best of two
    rounds run wrapper, op, op, wrapper: what routing the wrappers through
    ``torch.ops.vitlens.*`` would cost each launch."""
    from vitlens_tpu_torch.ops.flash_attention import flash_attention
    from vitlens_tpu_torch.ops.fused_mlp import fused_mlp

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(1, 1, 64, 64, generator=g, device="cuda").to(torch.bfloat16)
    a = mlp_inputs(torch, g, 64, 64, 256)
    pairs = {"flash_attention": (lambda: flash_attention(q, q, q),
                                 lambda: torch.ops.vitlens.flash_attention(q, q, q, 0.125)),
             "fused_mlp": (lambda: fused_mlp(*a),
                           lambda: torch.ops.vitlens.fused_mlp(*a, "gelu", 1e-5))}

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e6

    out = {}
    with torch.no_grad():
        for name, (direct, op) in pairs.items():
            if not torch.equal(direct(), op()):
                fail(f"4ex: torch.ops.vitlens.{name} differs from its wrapper")
            times = [per_call(f) for f in (direct, op, op, direct)]
            out[name] = (round(min(times[0], times[3]), 2),
                         round(min(times[1], times[2]), 2))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.time()

    def mark(label):  # where the run's time goes, phase by phase
        print(f"[time] {label} done at {time.time() - t_start:.1f} s", flush=True)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.ops import _build
    from vitlens_tpu_torch.ops.attention import plain_attention
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)
    from vitlens_tpu_torch.ops.fps import fps_indices, fps_indices_reference
    from vitlens_tpu_torch.ops.fused_ln_proj import (fused_ln_proj,
                                                     ln_proj_reference)
    from vitlens_tpu_torch.ops.fused_mlp import (fused_mlp, fused_mlp_reference,
                                                 fused_mlp_save_preact)
    from vitlens_tpu_torch.ops.fused_mlp_chain import (fused_attnout_mlp,
                                                       fused_mlp_chunked)
    from vitlens_tpu_torch.ops.fused_point_encoder import (
        fused_point_encoder, point_encoder_reference)
    from vitlens_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                   int8_matmul_dequant,
                                                   int8_quantize)
    from vitlens_tpu_torch.ops.row_gather import row_gather

    # The kernels of the JSON line (the save-preact variant is kernel 1's; the
    # LN + qkv prototype's kernel is the fused LN + projection, held and timed
    # at the prototype's shape under its own name; kernel 10's two epilogues
    # are two entries) and every launch counter, by variant.
    kernels = {"fused_mlp": fused_mlp, "flash_attention": flash_attention,
               "fps": fps_indices, "point_encoder": fused_point_encoder,
               "fused_ln_proj": fused_ln_proj, "int8_matmul": int8_matmul,
               "int8_matmul_dequant": int8_matmul_dequant,
               "int8_quantize": int8_quantize,
               "row_gather": row_gather, "fused_mlp_chunked": fused_mlp_chunked,
               "fused_attnout_mlp": fused_attnout_mlp,
               "fused_ln_qkv": fused_ln_proj}
    counters = launch_counters()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)

    t0 = time.time()
    _build.library()
    print(f"[2 build] kernels built and loaded in {time.time() - t0:.1f} s "
          f"({_build.BUILD_ROOT / _build.source_hash()})", flush=True)

    # -- 3: each kernel against its plain version on the card ---------------
    g = torch.Generator(device="cuda").manual_seed(SEED)
    err = {name: 0.0 for name in kernels}
    checks = []
    # the last: the video distill step's image tower at B64 (8 frames of
    # 257 tokens a sample), the largest M on any path
    # (8 * 513, 384, 1536): the PointTransformer's blocks at B8 (phase 4o)
    for m, d, h in ((6168, 1024, 4096), (616, 768, 3072), (1001, 1024, 4096),
                    (4100, 1024, 4096), (4100, 1664, 8192), (154, 1280, 5120),
                    (8 * 513, 384, 1536), (B * 8 * 257, 1024, 4096)):
        for act in ("gelu", "quick_gelu"):
            a = mlp_inputs(torch, g, m, d, h)
            got = fused_mlp(*a, act=act)
            torch.cuda.synchronize()
            want = fused_mlp_reference(*a, act=act)
            e = rel_err(got, want)
            err["fused_mlp"] = max(err["fused_mlp"], abs_err(got, want))
            checks.append(f"mlp{m}x{d}x{h}/{act}={e:.2e}")
            if not (torch.isfinite(got).all() and e <= MLP_TOL):
                fail(f"fused_mlp {m}x{d}x{h} {act}: rel err {e} > {MLP_TOL}")
    # the main paths' shapes, then the video Lens cross (8 frames x 256
    # tokens), a ragged NK beside it, the EEG (and pc) Lens cross at B64 and
    # the video distill step's image tower at B64 (512 frames)
    for b, h, nq, nk in ((12, 16, 257, 257), (12, 1, 256, 600),
                         (12, 16, 256, 256), (8, 1, 256, 512),
                         (B, 1, 256, 2048), (B, 1, 256, 2040), (B, 1, 256, 512),
                         (8, 6, 513, 513), (B * 8, 16, 257, 257)):
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v)
        e = rel_err(got, want)
        err["flash_attention"] = max(err["flash_attention"], abs_err(got, want))
        checks.append(f"attn{b}x{h}x{nq}x{nk}={e:.2e}")
        if not (torch.isfinite(got).all() and e <= ATTN_TOL):
            fail(f"flash_attention {b}x{h}x{nq}x{nk}: rel err {e} > {ATTN_TOL}")
    check_attention_edges(torch, g, err, checks)
    check_head_dims(torch, g, err, checks)
    fps_timed = {}
    for b, n, npoint, cloud, starts in FPS_CASES:
        xyz, start = fps_inputs(torch, g, b, n, cloud, starts)
        if (n, npoint, cloud, starts) == (8192, 512, "random", "zero"):
            fps_timed[b] = (xyz, start)
        got = fps_indices(xyz, npoint, start)
        torch.cuda.synchronize()
        want = fps_indices_reference(xyz, npoint, start)
        n_diff = (got != want).sum().item()
        err["fps"] = max(err["fps"], abs_err(got, want))
        checks.append(f"fps{b}x{n}/{npoint}/{cloud}/{starts}:{n_diff}-differ")
        if n_diff:
            fail(f"fps_indices B{b} N{n} npoint {npoint} {cloud} cloud, {starts} "
                 f"starts: {n_diff} indices differ from the plain version")
        del xyz, start, got, want
    err["point_encoder"] = 0.0
    # Every M on 21 groups (a ragged last tile); then many tiles a CTA (more
    # than 2 x 132) with groups straddling the two consumers (M = 48, 80,
    # 128); C4 = 384 (three passes of 128 columns) and 512 (two of 256);
    # last the pc encode's B64 shape, timed in phase 5.
    for bg_shape, m, c4 in (((3, 7), 16, 256), ((3, 7), 32, 256),
                            ((3, 7), 48, 256), ((3, 7), 64, 256),
                            ((3, 7), 128, 256), ((B, 512), 48, 256),
                            ((3, 101), 80, 256), ((3, 101), 128, 256),
                            ((3, 101), 48, 384), ((3, 7), 128, 512),
                            ((B, 64), 32, 512), ((B, 512), 32, 256)):
        args = enc_inputs(torch, g, bg_shape, m, c4)
        got = fused_point_encoder(*args)
        torch.cuda.synchronize()
        want = point_encoder_reference(*args)
        e = rel_err(got, want)
        err["point_encoder"] = max(err["point_encoder"], abs_err(got, want))
        label = "x".join(map(str, bg_shape))
        checks.append(f"enc{label}x{m}/{c4}={e:.2e}")
        if not (torch.isfinite(got).all() and e <= ENC_TOL):
            fail(f"fused_point_encoder {label} M={m} C4={c4}: rel err {e} > "
                 f"{ENC_TOL}")
    enc_args = args  # [B, 512, 32]: timed in phase 5
    for m, d, h in ((6168, 1024, 4096), (1001, 1024, 4096), (4100, 1024, 4096),
                    (616, 768, 3072), (4100, 1664, 8192)):
        for act in ("gelu", "quick_gelu"):
            a = mlp_inputs(torch, g, m, d, h)
            got, pre = fused_mlp_save_preact(*a, act=act)
            torch.cuda.synchronize()
            want, want_pre = fused_mlp_reference(*a, act=act, save_preact=True)
            e, e_pre = rel_err(got, want), rel_err(pre, want_pre)
            err["fused_mlp"] = max(err["fused_mlp"], abs_err(got, want),
                                   abs_err(pre, want_pre))
            checks.append(f"preact{m}x{d}x{h}/{act}=out {e:.2e},a {e_pre:.2e}")
            if not (torch.isfinite(got).all() and torch.isfinite(pre).all()
                    and e <= MLP_TOL and e_pre <= PREACT_TOL):
                fail(f"fused_mlp_save_preact {m}x{d}x{h} {act}: rel err out {e}, a "
                     f"{e_pre} > {MLP_TOL}, {PREACT_TOL}")
    err["fused_ln_proj"] = 0.0
    for m, d, n in ((6168, 1024, 3072), (1001, 1024, 3072), (6168, 768, 2304),
                    (1001, 768, 2304), (4100, 1664, 4992), (77, 1664, 4992)):
        a = ln_proj_inputs(torch, g, m, d, n)
        got = fused_ln_proj(*a)
        torch.cuda.synchronize()
        want = ln_proj_reference(*a)
        e = rel_err(got, want)
        err["fused_ln_proj"] = max(err["fused_ln_proj"], abs_err(got, want))
        checks.append(f"lnproj{m}x{d}x{n}={e:.2e}")
        if not (torch.isfinite(got).all() and e <= LNP_TOL):
            fail(f"fused_ln_proj {m}x{d}x{n}: rel err {e} > {LNP_TOL}")
    check_new_kernels(torch, g, err, checks)
    check_item11_kernels(torch, g, err, checks)
    check_coca_kernels(torch, g, err, checks)
    check_int8_epilogues(torch, g, err, checks)
    digests = kernel1_digests(torch, np)
    if digests != {k: tuple(v) for k, v in KERNEL1_DIGESTS.items()}:
        fail(f"kernel 1's outputs changed: digests {digests}, the parent "
             f"build's {KERNEL1_DIGESTS}")
    checks.append("kernel1-acts0,1-bit-identical-to-parent")
    print(f"[3 kernels] all within bound (mlp <= {MLP_TOL}, save-preact a <= "
          f"{PREACT_TOL}, attn <= {ATTN_TOL} at head dims 64 and {OTHER_HEAD_DIMS}, "
          f"ln_proj <= {LNP_TOL}, encoder <= {ENC_TOL}, chained mlp <= "
          f"{CHAIN_TOL} relative, fps index-exact, int8 product (both "
          f"epilogues), quantise and row gather bit-equal): {' '.join(checks)}",
          flush=True)

    mark("3 kernels")
    grad_checks = {
        "fused_mlp M1001 gelu": (
            fused_mlp, fused_mlp_reference, mlp_inputs(torch, g, 1001, 1024, 4096),
            GRAD_TOL, ("dx", "dlnw", "dlnb", "dw1", "db1", "dw2", "db2")),
        "fused_ln_proj M1001 1024->3072": (
            fused_ln_proj, ln_proj_reference,
            ln_proj_inputs(torch, g, 1001, 1024, 3072), GRAD_TOL,
            ("dx", "dlnw", "dlnb", "dw", "db")),
        "attention [2,16,257,257]": (
            flash_attention, attention_reference,
            qkv_inputs(torch, g, 2, 16, 257, 257), ATTN_GRAD_TOL,
            ("dq", "dk", "dv")),
        "attention [2,1,256,600]": (
            flash_attention, attention_reference,
            qkv_inputs(torch, g, 2, 1, 256, 600), ATTN_GRAD_TOL,
            ("dq", "dk", "dv")),
        # the CLIPBind step's (phase 4o): kernel 1 at bigG's D 1664 / H 8192
        # (B16 x 257 rows) and kernel 2 at head dim 104 in the trunk and the
        # Lens's cross and self blocks
        "fused_mlp M4112 1664->8192 gelu": (
            fused_mlp, fused_mlp_reference,
            mlp_inputs(torch, g, OS_B * 257, 1664, 8192), GRAD_TOL,
            ("dx", "dlnw", "dlnb", "dw1", "db1", "dw2", "db2")),
        **{f"attention {label} [{b},{h},{nq},{nk},104]": (
            flash_attention, attention_reference,
            qkv_inputs(torch, g, b, h, nq, nk, 104), ATTN_GRAD_TOL,
            ("dq", "dk", "dv"))
           for label, (b, h, nq, nk) in (("bigG trunk", (OS_B, 16, 257, 257)),
                                         ("Lens cross", (OS_B, 1, 256, 512)),
                                         ("Lens self", (OS_B, 16, 256, 256)))},
        **item11_grad_checks(torch, g), **coca_grad_checks(torch, g)}
    lines = []
    for label, (fn, plain, args, tol, names) in grad_checks.items():
        errs = grad_errs(torch, g, fn, plain, args)
        lines.append(f"{label}: " + ", ".join(
            f"{n} {e:.2e}" for n, e in zip(names, errs)))
        if max(errs) > tol:
            fail(f"gradients of {label}: {dict(zip(names, errs))} > {tol}")
    del grad_checks
    print(f"[3 gradients] each Function's gradients against autograd of its "
          f"plain version, bf16 (<= {GRAD_TOL}, attention <= {ATTN_GRAD_TOL} "
          f"relative): " + "; ".join(lines), flush=True)

    mark("3 gradients")
    # -- 4: the slices through the port's entry point -----------------------
    t0 = time.time()
    model = ViTLens("vitlensL", ("audio", "pc", "text"), device="cuda",
                    compute_dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    acfg, pcfg = model.towers["audio"].cfg, model.towers["pc"].cfg
    n_layers, n_text = acfg.arch.layers, model.towers["text"].cfg.layers

    want_launches = {"audio": tower_launches(acfg),
                     "pc": tower_launches(pcfg, fps=1, point_encoder=1),
                     "text": launch_counts(fused_mlp=n_text)}
    captions = ["a dog barking in the distance", "rain on a tin roof",
                "an orchestra tuning up", "a car engine starting",
                "birds singing at dawn", "a crowd cheering in a stadium",
                "typing on a keyboard", "waves crashing on rocks"]
    fbanks = {b: torch.randn(b, 3, acfg.audio.target_length, acfg.audio.mel_bins,
                             generator=g, device="cuda") * 0.5
              for b in (1, 4, 8)}
    npts = pcfg.point.npoints
    # rounded through bf16 once, so the fp32 CPU run sees what the card sees
    clouds = {b: (torch.randn(b, npts, 3, generator=g, device="cuda") * 0.3)
              .bfloat16().float() for b in (1, 4, 8)}
    rng = np.random.RandomState(SEED)
    raw = [(rng.randn(9000, 3) * 0.3).astype(np.float32) for _ in range(2)]

    requests = [*(("audio", b, {"audio": fb}, True) for b, fb in fbanks.items()),
                *(("pc", b, {"pc": c}, True) for b, c in clouds.items()),
                ("pc", len(raw), {"pc": raw}, False),
                ("text", len(captions), {"text": captions}, False)]
    launches = dict.fromkeys(COUNTED, 0)
    outs, per_call = [], []
    for path, b, inputs, pre in requests:
        emb, counts = run_counted(
            torch, counters, launches,
            lambda: model.encode(inputs, preprocessed=pre)[path])
        per_call.append((path, b, tuple(counts[k] for k in (
            "fused_mlp", "flash_attention", "fps", "point_encoder"))))
        outs.append((path, b, pre, emb))
        if counts != want_launches[path]:
            fail(f"{path} B={b}: launches {counts}, expected {want_launches[path]}")
    for path, b, pre, emb in outs:
        if tuple(emb.shape) != (b, 768) or not torch.isfinite(emb).all():
            fail(f"{path} B={b}: shape {tuple(emb.shape)} or non-finite values")
        norm_err = (emb.float().norm(dim=-1) - 1).abs().max().item()
        if norm_err > 1e-3:
            fail(f"{path} B={b}: norms off 1 by {norm_err}")

    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    ref.compute_dtype = torch.float32
    card_emb = {path: emb for path, b, pre, emb in outs if b == 1 or path == "text"}
    want = {"audio": ref.encode({"audio": fbanks[1].cpu()}, preprocessed=True),
            "pc": ref.encode({"pc": clouds[1].cpu()}, preprocessed=True),
            "text": ref.encode({"text": captions})}
    cos = {path: torch.nn.functional.cosine_similarity(
        card_emb[path].float().cpu(), want[path][path].float(), dim=-1).min().item()
        for path in want}
    # A group size the point-encoder kernel does not take (M = 24): the
    # tokenizer's gate sends the groups to the plain encoder, on both.
    tok_card, tok_ref = model.towers["pc"].adapter, ref.towers["pc"].adapter
    saved = (tok_card.cfg, tok_ref.cfg)
    tok_card.cfg = tok_ref.cfg = dataclasses.replace(tok_card.cfg, group_size=24)
    try:
        emb24, counts24 = run_counted(
            torch, counters, launches,
            lambda: model.encode({"pc": clouds[1]}, preprocessed=True)["pc"])
        want24 = ref.encode({"pc": clouds[1].cpu()}, preprocessed=True)["pc"]
    finally:
        tok_card.cfg, tok_ref.cfg = saved
    if counts24 != tower_launches(pcfg, fps=1):
        fail(f"pc B=1 at group size 24: launches {counts24}, expected no "
             "point-encoder launch")
    cos["pc group size 24"] = torch.nn.functional.cosine_similarity(
        emb24.float().cpu(), want24.float(), dim=-1).min().item()
    del ref
    n_group = pcfg.point.num_group
    idx_card = fps_indices(clouds[1].bfloat16(), n_group).cpu()
    idx_cpu = fps_indices(clouds[1].cpu(), n_group)
    if not torch.equal(idx_card, idx_cpu):
        fail(f"pc B=1: {(idx_card != idx_cpu).sum().item()} FPS indices of "
             "the card run differ from the CPU run's")
    if min(cos.values()) < COS_MIN:
        fail(f"card bf16 vs CPU fp32: min cosine {cos} < {COS_MIN}")
    print(f"[4 slice] vitlensL audio+pc+text built in {build_s:.1f} s; requests "
          f"(path, B, launches (mlp, attn, fps, encoder)) {per_call}; "
          f"main-path totals {launches}; min cosine vs CPU fp32 plain path: "
          + " ".join(f"{k} {v:.6f}" for k, v in cos.items())
          + f"; pc B=1 FPS indices equal on card and CPU ({n_group} centers); "
          f"pc B=1 at group size 24 through the plain encoder, launches "
          f"{tuple(counts24[k] for k in ('fused_mlp', 'flash_attention', 'fps', 'point_encoder'))}",
          flush=True)

    # -- 4v: served from files -------------------------------------------------
    mark("4")
    served = served_phase(torch, np, counters, launches, card)
    transformer_lens_phase(torch, counters, launches)

    # -- 4f: the fp32 default; 4h: head dims other than 64 --------------------
    mark("4v, 4t")
    fp32_phase(torch, counters, launches, fbanks[4][:2], clouds[4][:2],
               captions[:2])
    head_dim_phase(torch, counters, launches, fbanks[1])

    # -- 4g: the vitlensG pc encode (PNSA, bigG) from files, and served -------
    mark("4f, 4h")
    g_model = vitlensG_phase(torch, np, counters, launches)

    # -- 4q: the int8 quantized audio encode; 4s: the bench entry points -----
    mark("4g")
    fb64 = torch.randn(B, 3, acfg.audio.target_length, acfg.audio.mel_bins,
                       generator=g, device="cuda") * 0.5
    qmodel = quant_phase(
        torch, model, counters, launches, fbanks[1], fb64, captions,
        {"audio": launch_counts(int8_matmul_dequant=4 * n_layers,
                                int8_quantize=4 * n_layers,
                                flash_attention=want_launches["audio"][
                                    "flash_attention"]),
         "text": want_launches["text"],
         "text_int8": launch_counts(int8_matmul_dequant=4 * n_text,
                                    int8_quantize=4 * n_text)})
    by_script = scripts_phase(torch, counters, launches)

    # -- 4b, 4c: the audio train step -----------------------------------------
    mark("4q, 4s")
    trainer, state, tx, mask, sc, train_batch = train_phase(torch, np, counters,
                                                            launches)

    # -- 4d: the depth tri step; 4e: the video distill-tokens step ----------
    mark("4b, 4c")
    from vitlens_tpu_torch.train.step import StepConfig

    tri_depth = tri_train_phase(
        torch, np, counters, launches, "4d tri train", "depth",
        dict(lock_image=True, lock_text=True, lock_visual=True,
             unlock_trans_first_n_layers=4),
        StepConfig(n_tower=3, compute_dtype=torch.bfloat16),
        [("B=8", 8, 1)] * 3 + [("B=8 accum_freq 4", 8, 4)] * 2)
    tri_video = tri_train_phase(
        torch, np, counters, launches, "4e video distill", "video",
        dict(lock_image=True, lock_text=True, lock_visual=True),
        StepConfig(n_tower=3, video_distill=True,
                   contra_loss_type="distill_token",
                   compute_dtype=torch.bfloat16),
        [("B=4 accum_freq 2", 4, 2)] * 2, frames=8)
    # -- 4p: the pc tri step (batch BatchNorm, random FPS starts) -----------
    tri_pc = tri_train_phase(
        torch, np, counters, launches, "4p pc tri train", "pc",
        dict(lock_image=True, lock_text=True, lock_visual=True),
        StepConfig(n_tower=3, compute_dtype=torch.bfloat16),
        [("B=8", 8, 1)] * 2 + [("B=8 accum_freq 4", 8, 4)] * 2)
    # -- 4x: the training CLI (files, eval, checkpoints, resume) ----------
    mark("4d, 4e, 4p")
    cli = train_cli_phase(torch, np, counters, launches, card)
    # -- 4o: the OpenShape trainer (vitlensG, the baselines, the PointBERT
    # classifier, the CLI); its phase-5 timings run inside, on its models
    mark("4x")
    os_rates = openshape_phase(torch, np, counters, launches, card)

    # -- ROADMAP item 11: 4ev EVA-g, 4l LoRA, 4rb RoBERTa, 4r RN50, 4lp the
    # linear probe, 4i the infer CLI, 4ex export ------------------------------
    mark("4o")
    eva_rates = eva_phase(torch, np, counters, launches, card)
    lora_phase(torch, np, counters, launches, card)
    hf_text_phase(torch, np, counters, launches, card)
    resnet_phase(torch, np, counters, launches, card)
    lp_steps = linprobe_phase(torch, np, card)
    infer_phase(torch, np, card)
    export_phase(torch, model, counters, launches, card, fbanks[4][:2])

    # -- 4co: CoCa (coca_ViT-L-14 and coca_ViT-B-32); its phase-5 rates run
    # inside, on its model
    mark("4ev, 4l, 4rb, 4r, 4lp, 4i, 4ex")
    coca_rates = coca_phase(torch, np, counters, launches, card)
    mark("4co")
    # -- 5: timing at the B64 shapes -----------------------------------------
    timings = {name: [] for name in kernels}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, (m, d, h) in (("audio trunk", (257 * B * 3, 1024, 4096)),
                             ("pc trunk", (257 * B, 1024, 4096)),
                             ("text", (77 * B, 768, 3072))):
        a = mlp_inputs(torch, g, m, d, h)
        k_ms, p_ms = paired_ms(lambda: fused_mlp(*a), lambda: fused_mlp_reference(*a))
        bd, by = mlp_bound(m, d, h)
        x, lnw, lnb, w1, b1, w2, b2 = a
        y = torch.nn.functional.layer_norm(x.float(), (d,), lnw, lnb).bfloat16()
        hid = torch.empty(m, h, dtype=torch.bfloat16, device="cuda")
        b1h, b2h = b1.bfloat16(), b2.bfloat16()
        gemm_ms = cuda_ms(lambda: (torch.addmm(b1h, y, w1, out=hid),
                                   torch.addmm(b2h, hid, w2)))
        timings["fused_mlp"].append(
            {"shape": f"{label} M={m} D={d} H={h}", "ms": k_ms, "plain_ms": p_ms,
             "gemm_only_ms": gemm_ms, "bound_ms": bd, "bound_by": by,
             "library_ms": None, "tflops": 4 * m * d * h / k_ms / 1e9})
        del a, x, y, hid
    m = 257 * B  # the B64 train step's audio trunk
    a = mlp_inputs(torch, g, m, 1024, 4096)
    k_ms, p_ms = paired_ms(lambda: fused_mlp_save_preact(*a),
                           lambda: fused_mlp_reference(*a, save_preact=True))
    bd, by = preact_bound(m, 1024, 4096)
    timings["fused_mlp"].append(
        {"shape": f"save-preact variant, train trunk M={m} D=1024 H=4096",
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
         "library_ms": None, "plain_variant_ms": cuda_ms(lambda: fused_mlp(*a)),
         "tflops": 4 * m * 1024 * 4096 / k_ms / 1e9})
    del a
    for label, (m, d, n) in (("audio encode trunk", (257 * B * 3, 1024, 3072)),
                             ("train trunk", (257 * B, 1024, 3072)),
                             ("text", (77 * B, 768, 2304))):
        a = ln_proj_inputs(torch, g, m, d, n)
        k_ms, p_ms = paired_ms(lambda: fused_ln_proj(*a),
                               lambda: ln_proj_reference(*a), plain_iters=5)
        x, lnw, lnb, w, b = a
        y = torch.nn.functional.layer_norm(x.float(), (d,), lnw, lnb).bfloat16()
        gemm_ms = cuda_ms(lambda: torch.addmm(b.bfloat16(), y, w))
        bd, by = ln_proj_bound(m, d, n)
        timings["fused_ln_proj"].append(
            {"shape": f"{label} M={m} D={d} N={n}", "ms": k_ms, "plain_ms": p_ms,
             "gemm_only_ms": gemm_ms, "bound_ms": bd, "bound_by": by,
             "library_ms": None, "tflops": 2 * m * d * n / k_ms / 1e9})
        del a, x, y, w
    for label, (b, h, nq, nk, dh) in (("audio trunk", (B * 3, 16, 257, 257, 64)),
                                      ("audio lens cross", (B * 3, 1, 256, 600, 64)),
                                      ("audio lens self", (B * 3, 16, 256, 256, 64)),
                                      ("pc and EEG lens cross", (B, 1, 256, 512, 64)),
                                      ("video lens cross", (B, 1, 256, 2048, 64)),
                                      ("bigG trunk", (B * 3, 16, 257, 257, 104))):
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk, dh)
        k_ms, p_ms = paired_ms(lambda: flash_attention(q, k, v),
                               lambda: attention_reference(q, k, v))
        bf16_ms = cuda_ms(lambda: plain_attention(q, k, v, None, dh ** -0.5))
        lib_ms = cuda_ms(lambda: sdpa(q, k, v))
        bd, by = attn_bound(b, h, nq, nk, dh)
        # the kernel's device time beside the call's: a short call through
        # the Python wrapper can be bound by the host's enqueue
        row = {"shape": f"{label} [{b},{h},{nq},{nk},{dh}]", "ms": k_ms,
               "device_ms": device_ms(torch, lambda: flash_attention(q, k, v)),
               "plain_ms": p_ms, "plain_bf16_ms": bf16_ms, "bound_ms": bd,
               "bound_by": by, "library_ms": lib_ms}
        if label == "audio trunk":  # as the trunk calls it: packed-qkv views
            qkv = torch.randn(b, nq, 3 * h * 64, generator=g,
                              device="cuda").bfloat16()
            qv, kv_, vv = qkv.view(b, nq, 3, h, 64).permute(2, 0, 3, 1, 4)
            row["packed_views_ms"] = cuda_ms(lambda: flash_attention(qv, kv_, vv))
            del qkv, qv, kv_, vv
        timings["flash_attention"].append(row)
        del q, k, v
    for b in (B, 1):  # the pc encode's batch (C = 2), and one request (C = 4)
        xyz, start = fps_timed[b]
        k_ms, p_ms = paired_ms(lambda: fps_indices(xyz, 512, start),
                               lambda: fps_indices_reference(xyz, 512, start),
                               plain_iters=3)
        bd, by = fps_bound(b, 8192, 512)
        timings["fps"].append({"shape": f"B{b} N8192 npoint512", "ms": k_ms,
                               "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
                               "library_ms": None})
    k_ms, p_ms = paired_ms(lambda: fused_point_encoder(*enc_args),
                           lambda: point_encoder_reference(*enc_args),
                           plain_iters=5)
    bd, by = enc_bound(B * 512, 32, *ENC_WIDTHS)
    timings["point_encoder"].append(
        {"shape": f"[{B},512,32,3] -> [{B},512,256]", "ms": k_ms,
         "plain_ms": p_ms, "bound_ms": bd, "bound_by": by, "library_ms": None})
    del enc_args, fps_timed
    time_new_kernels(torch, g, timings)
    time_item11_kernels(torch, g, timings)
    time_coca_kernels(torch, g, timings)
    timings["fused_ln_qkv"] = [timings["fused_ln_proj"][1]]  # M=16448, 1024->3072
    for name, rows in timings.items():
        for r in rows:
            print(f"[5 timing] {card} | {name} {r['shape']}: kernel "
                  f"{r['ms']:.4f} ms"
                  + (f" (device {r['device_ms']:.4f} ms)" if "device_ms" in r else "")
                  + f", plain {r['plain_ms']:.4f} ms"
                  + (f", plain bf16 {r['plain_bf16_ms']:.4f} ms"
                     if "plain_bf16_ms" in r else "")
                  + (f", plain variant {r['plain_variant_ms']:.4f} ms"
                     if "plain_variant_ms" in r else "")
                  + (f", cuBLAS addmm products alone (GEMM only) "
                     f"{r['gemm_only_ms']:.4f} ms" if "gemm_only_ms" in r else "")
                  + (f", kernel on the packed-qkv views {r['packed_views_ms']:.4f} ms"
                     if "packed_views_ms" in r else "")
                  + (f", through the wrapper back to back {r['wrapper_ms']:.4f} ms"
                     f" (host {r['host_us']:.2f} us a call; index_select device "
                     f"{r['library_device_ms']:.4f} ms, host {r['library_host_us']:.2f} us)"
                     if "wrapper_ms" in r else "")
                  + (f", library {r['library_ms']:.4f} ms"
                     if r["library_ms"] is not None else "")
                  + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  + (f", kernel {r['tflops']:.1f} TFLOP/s" if "tflops" in r else "")
                  + (f", kernel {r['tops']:.1f} TOP/s" if "tops" in r else "")
                  + (f", three-launch fused MLP on the same function "
                     f"{r['three_launch_ms']:.4f} ms" if "three_launch_ms" in r else "")
                  + (f", today's split (library out-projection + residual, "
                     f"then the three-launch fused MLP) {r['today_split_ms']:.4f} ms"
                     if "today_split_ms" in r else ""),
                  flush=True)

    mark("5 kernels")
    pc64 = torch.randn(B, npts, 3, generator=g, device="cuda") * 0.3

    def audio64():
        return model.encode({"audio": fb64}, preprocessed=True)["audio"]

    def pc64_encode():
        return model.encode({"pc": pc64}, preprocessed=True)["pc"]

    def qaudio64():
        return qmodel.encode({"audio": fb64}, preprocessed=True)["audio"]

    audio_rate = encode_rate(torch, card, f"audio encode B{B} x 3 clips bf16",
                             audio64, B, rows_note=f" ({B * 3} clips per call)")
    pc_rate = encode_rate(torch, card, f"pc encode B{B} x {npts} points bf16",
                          pc64_encode, B)
    pc1_ms = encode_latency(
        torch, card, f"pc encode B=1 x {npts} points bf16 (one request)",
        lambda: model.encode({"pc": clouds[1]}, preprocessed=True)["pc"])
    os.environ["VITLENS_ENABLE_FUSED_LNQKV"] = "1"
    try:
        encode_rate(torch, card, f"audio encode B{B} x 3 clips bf16, opt-in "
                    "fused LN + qkv", audio64, B,
                    rows_note=f" ({B * 3} clips per call)")
    finally:
        del os.environ["VITLENS_ENABLE_FUSED_LNQKV"]
    q_rates = [encode_rate(torch, card, f"audio encode B{B} x 3 clips, int8 "
                           "(W8A8) quantized trunk, bf16 elsewhere", qaudio64, B,
                           rows_note=f" ({B * 3} clips per call)")]
    audio_again = encode_rate(torch, card, f"audio encode B{B} x 3 clips bf16 "
                              "(again, default)", audio64, B,
                              rows_note=f" ({B * 3} clips per call)")
    q_rates.append(encode_rate(torch, card, f"audio encode B{B} x 3 clips, int8 "
                               "(W8A8) quantized trunk (again)", qaudio64, B,
                               rows_note=f" ({B * 3} clips per call)"))
    profile_encode(torch, card, f"B{B} audio encode", audio64)
    profile_encode(torch, card, f"B{B} int8 quantized audio encode", qaudio64)
    del qmodel
    profile_encode(torch, card, f"B{B} pc encode", pc64_encode)

    from vitlens_tpu_torch.train.step import make_train_step

    train_step = make_train_step(trainer.cfg, tx, mask, sc)
    batch64 = {k: v.cuda() for k, v in train_batch(B).items()}

    def step64():
        train_step(state, batch64)

    train_rates = {False: [], True: []}
    for opt_in in (False, True, True, False):
        if opt_in:
            os.environ["VITLENS_ENABLE_FUSED_LNQKV"] = "1"
        try:
            train_rates[opt_in] += [train_rate(torch, card, f"audio train step B{B} bf16 (recipe: "
                       f"lock visual + text, unlock CLS; no remat)"
                       + (", opt-in fused LN + qkv" if opt_in else ""), step64, B)]
        finally:
            os.environ.pop("VITLENS_ENABLE_FUSED_LNQKV", None)
    profile_encode(torch, card, f"B{B} audio train step", step64)
    # -- 4dp (a), 4fs (a): the same step over a world-size-1 NCCL group, then
    # under FSDP on it (the model is placed for good) -------------------------
    fs_a = dp_nccl_phase(torch, np, counters, launches, trainer, state, tx,
                         mask, sc, train_batch)
    del trainer, state, train_step, batch64
    tri_rates = tri_timings(torch, np, card, [(tri_depth, 0, (B,)),
                                              (tri_video, 8, (B, 32)),
                                              (tri_pc, 0, (B, 32))])
    del tri_depth, tri_video, tri_pc
    g_rate = vitlensG_timings(torch, card, g_model)
    del g_model
    served_rates = served_timings(torch, np, card, served)
    host_library_timings(torch, np, card, served)
    train_cli_timings(card, cli)
    shutil.rmtree(served["root"], ignore_errors=True)
    del served

    mark("5 rates")
    # -- 4dp (b): two ranks sharing the card; (c): the mesh encode and serve --
    del model, fb64, pc64, audio64, pc64_encode, qaudio64, step64
    fs_bc = dp_ranks_phase(torch, launches, card)
    dp_encode_phase(torch, np, counters, launches, card)
    print(f"[4fs] {card} | phase 4fs {fs_a + fs_bc:.1f} s: (a) {fs_a:.1f} s, "
          f"(b) and (c) {fs_bc:.1f} s in the rank processes", flush=True)
    mark("4dp, 4fs")
    # -- 4tp: four ranks sharing the card, [data 2, model 2] ------------------
    # -- 4pp: pipelined trunks, in 4tp's ranks after (b) --------------------
    tp_s = tp_ranks_phase(torch, launches, card)
    print(f"[4tp] {card} | phases 4tp and 4pp {tp_s:.1f} s; whole run so far "
          f"{time.time() - t_start:.1f} s", flush=True)
    mark("4tp, 4pp")
    replaces = {
        "fused_mlp": "vitlens_tpu/ops/fused_mlp.py:105",
        "flash_attention": "vitlens_tpu/ops/flash_attention.py:53",
        "fps": "vitlens_tpu/ops/fps.py:120, vitlens_tpu/ops/fps.py:175",
        "point_encoder": "vitlens_tpu/ops/fused_point_encoder.py:116",
        "fused_ln_proj": "vitlens_tpu/ops/fused_ln_proj.py:56",
        "int8_matmul": "scripts/bench_int8_native.py:64",
        "int8_matmul_dequant": "scripts/bench_int8_native.py:64 (with the XLA-fused "
                               "tail of vitlens_tpu/quant.py:84)",
        "int8_quantize": "vitlens_tpu/quant.py:77 (the XLA-fused head of "
                         "int8_matmul; no pallas_call)",
        "row_gather": "scripts/bench_dma_gather.py:49",
        "fused_mlp_chunked": "scripts/fused_mlp_pallas.py:91",
        "fused_attnout_mlp": "scripts/fused_attnout_mlp_pallas.py:62",
        "fused_ln_qkv": "scripts/fused_ln_qkv_pallas.py:48"}
    sources = {"fused_mlp": "fused_mlp.cu", "flash_attention": "flash_attention.cu",
               "fps": "fps.cu", "point_encoder": "fused_point_encoder.cu",
               "fused_ln_proj": "fused_ln_proj.cu", "int8_matmul": "int8_matmul.cu",
               "int8_matmul_dequant": "int8_matmul.cu",
               "int8_quantize": "int8_matmul.cu",
               "row_gather": "row_gather.cu",
               "fused_mlp_chunked": "fused_mlp.cu",
               "fused_attnout_mlp": "fused_mlp_chain.cu",
               "fused_ln_qkv": "fused_ln_proj.cu"}
    # kernel 1's count is both variants'; the split is beside it
    by_variant = {"plain": launches["fused_mlp"],
                  "save_preact": launches["fused_mlp_save_preact"]}
    launches["fused_mlp"] += launches["fused_mlp_save_preact"]
    # the LN + qkv prototype's path is its entry point's run
    launches["fused_ln_qkv"] = by_script["fused_ln_qkv"]
    line = []
    for name in kernels:
        main = timings[name][0]
        line.append({
            "name": name, "route": "cuda",
            "source": f"vitlens_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": launches[name],
            **({"launches_by_variant": by_variant} if name == "fused_mlp" else {}),
            "max_abs_err": err[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shapes": timings[name]})
    for name, n in launches.items():
        if n == 0:
            fail(f"{name}: no launch on any main path")
    print(f"[done] {card} | audio encode B{B}: {audio_rate:.2f} and "
          f"{audio_again:.2f} samples/s float bf16, {q_rates[0]:.2f} and "
          f"{q_rates[1]:.2f} int8 quantized "
          f"({max(q_rates) / max(audio_rate, audio_again):.3f}x); pc encode "
          f"B{B}: {pc_rate:.2f} samples/s, B=1 latency {pc1_ms:.2f} ms; audio "
          f"train step B{B}: {max(train_rates[False]):.2f} samples/s, opt-in "
          f"{max(train_rates[True]):.2f}; "
          + "; ".join(f"{k} train step B{b}: {r:.2f} samples/s"
                      for k, (b, r) in tri_rates.items())
          + f"; vitlensG pc encode B16: {g_rate:.2f} samples/s"
          + f"; CLIPBind (vitlensG) train step B{OS_B}: {os_rates['step']:.2f} "
          f"samples/s; baseline steps " + ", ".join(
              f"{k} {os_rates[k][1]:.2f} at B{os_rates[k][0]}"
              for k in ("PointBERT", "DGCNN", "PointNet"))
          + f" samples/s; PointTransformer encode B{B}: "
          f"{os_rates['point_transformer']:.2f} samples/s; OpenShape CLI step "
          f"{os_rates['cli_step_s']:.4f} s"
          + f"; EVA-g pc encode B16 {eva_rates[16]:.2f}, B64 {eva_rates[64]:.2f} "
          f"samples/s; linear probe step (host) {min(lp_steps[1:]):.4f} s"
          + f"; CoCa L-14 image encode B64 {coca_rates['encode']:.2f} samples/s, "
          f"forward + backward B16 {coca_rates['pass_s']:.4f} s a pass, beam-search "
          f"captions B=8 {coca_rates['captions']:.2f}/s"
          + f"; image, depth, EEG, video encode B{B}: "
          + ", ".join(f"{served_rates[m]:.2f}" for m in ("image", "depth", "eeg", "video"))
          + f" samples/s; served audio closed loop: "
          f"{served_rates['served_rps']:.2f} requests/s; whole run "
          f"{time.time() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pp-rank"]:
        sys.exit(pp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--dp-rank"]:  # --dp-rank [--lora] DIR
        sys.exit(dp_rank_main(sys.argv[-1], ("lora",) if "--lora" in
                              sys.argv[2:-1] else DP_RECIPES))
    if sys.argv[1:2] == ["--tp-rank"]:  # --tp-rank [--lora] DIR
        sys.exit(tp_rank_main(sys.argv[-1], "--lora" in sys.argv[2:-1]))
    sys.exit(main())
