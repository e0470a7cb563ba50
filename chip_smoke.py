"""Drive the PyTorch port (advise_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. environment: the card (nvidia-smi name and power limit), torch, CUDA and
   nvcc versions. No card, no run: there is no CPU fallback;
2. build: every kernel source of advise_tpu_torch/csrc/ (the stem conv, the
   fused simple aug, flash attention, the window probe, batch norm), one
   nvcc each, started together, each timed;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   same inputs (TF32 off): the stem kernels at the BYOL path's stem shape
   (both views, 32 clips), at one view's 16 clips (mem, and
   CONTRASTIVE.SEQUENTIAL's clip by clip) and at a ragged small shape,
   each with its plan (ops/stem_conv.py plan():
   tile, grid, waves, ring, partials) and its registers, spills and shared
   memory from the build's ptxas -v report (a spill in K1 or K2 fails); the
   fused aug K3 with its instances' registers, spills (a spill fails) and
   shared memory, exactly equal to its plain version in float32 and bf16
   out at SpeedPro's and at X3D-M's shapes (each preset's colour
   probability and p = 1) and at the card tests' edge shapes, each with its
   plan (ops/fused_aug.py
   plan(): cluster, bands, threads, pitch, shared memory, store width,
   grid, waves), timed on the card's clock (calls queued behind a sleep);
   flash attention forward and backward at every distinct attention
   shape of MViT-L 32x312 (2 views) and a ragged one, each with its kernels'
   grids, waves, registers and spills (ptxas -v of the build). Times are
   CUDA events, median of 20 in the order plain, kernel, kernel, plain
   (flash attention and its SDPA yardstick: each sample 10 calls back to
   back, so a wrapper's host time overlaps the card's work); beside
   them the least time the card could take (bytes or operations over the
   card's peak rates) and, where one PyTorch call computes the same
   function, that call's time (flash attention: scaled_dot_product_attention
   in bf16, with the backend that served it); K4's float32 pair
   (csrc/flash_attention_f32.cu, 3xTF32 on the tensor cores) in float32 at
   every distinct attention shape of MViT-L 32x312 and a ragged one above
   head dim 576, and in bf16 at head dim 800, against the plain versions,
   with its plan, its registers and spills (a spill fails) and the TF32 MMA
   count of its SASS (cuobjdump; none fails), SDPA in the same dtype as its
   library yardstick and both its bounds (3xTF32 on the tensor cores, and
   float32 on the CUDA cores). Also the stem kernels on their
   other launch schedules at the BYOL stem shape: K1' (TPU.PALLAS_STEM_CHUNK:
   K1 and K2 per batch chunk, chunk 8 and 12 -> 8) and K2' (TPU.
   PALLAS_STEM_WGRAD_ONLY: K2 over 16-sample chunks); and the window
   kernel of the nine Mosaic probes (P1-P9) at each probe's shape, exactly
   equal to its plain version, timed through its wrapper and alone (100
   launches back to back through its C entry point) beside the launch
   floor (the same at a one-element window), then the probe tool
   (advise_tpu_torch/tools/probe_windows.py) as its path;
4. small input: each full-width model's forward on the card (bf16) against
   the same weights' float32 forward on the CPU: SlowFast-R50 BYOL, the
   Slow-R50 speed model, and the full-depth MViT-L MaskFeat model at 4
   frames x 64^2; then that MViT-L with TPU.COMPUTE_DTYPE float32 on the
   card (flash attention through K4's float32 pair, its launches counted)
   against the same CPU forward, and one backward through the pair; then
   AdViSe (the ViT-B/16 tower and the R3D temporal head of
   configs/pretrain/AdViSe.yaml) at 2 clips x 8 frames at 224^2, bf16 on
   the card against float32 on the CPU; then the eval step (the inference
   crop, the eval-mode forward) of configs/eval/linear_probe_ucf.yaml's
   Slow-R50 (101 classes) on 2 clips of 8 frames at 256^2, bf16 on the card
   against float32 on the CPU; then X3D-M (configs/pretrain/X3D_M_K400.yaml,
   4 classes) on 2 clips of 16 frames and the MoCo Slow-R18 of
   configs/chip/moco_knn_minik400.yaml on 2 clips of 8 frames, both at
   112^2, bf16 on the card against float32 on the CPU; then Swin-B MoCo
   (configs/pretrain/SwinB_moco_32chips.yaml, built for 112^2: stage 4's
   grid pads 7 -> 8 and clamps its window to (8, 4, 4)) on 1 clip of 16
   frames, and AdViSe with the video_swin temporal head (TM.TEMPORAL_ARCH
   video_swin at TEMPORAL_EMBEDDING_DIM = TM.CHANNEL_POOL_DIM 384, 6 heads)
   on 2 clips, the same way; then the MAE model of
   configs/chip/mae_vismask_minik400.yaml (its prediction and VIS
   reconstruction, the same random masks handed to both) on 2 clips of 8
   frames at 112^2, and an MViTv2 classifier (MViT_S_rev_masked.yaml's
   MViT-S trunk with REL_POS_SPATIAL, REL_POS_TEMPORAL, RESIDUAL_POOLING and
   DIM_MUL_IN_ATT) on 2 clips of 8 frames at 112^2, bf16 on the card
   against float32 on the CPU, no kernel launched; then the op-exact
   RandAugment (AUG.FUSED_RA False) of the BYOL preset on 2 clips of 32
   frames at 298x224, the card against the CPU with the same draws, each
   of the 15 ops alone and the whole 'aa' pipeline (at most 0.1 % of the
   values a flipped uint8 step apart); and MViT-S as a classifier with the
   knobs of ROADMAP A 20 on (MVIT_KNOBS: plain and reversible), flash
   attention, bf16 on the card against float32 on the CPU, K4 once a
   block by its route (the bf16 pair to head dim 768, the float32 pair
   above); and MViT_S_rev_masked.yaml's MaskMViT with MVIT.REV.RESPATH_FUSE
   concat_linear_ln (FUSE_INTER), whose predictions come out of
   fuse_inter's float32 projection and LayerNorm, the same way;
5. the BYOL path: the SlowFast-R50 BYOL pretrain step of
   configs/pretrain/SlowFast_R50_K400.yaml at full width on one card, uint8
   clips through the 'aa' augmentation, 2 warm-up and 5 timed steps; then
   two short variants (1 warm-up and 2 timed steps each) with
   TPU.PALLAS_STEM_CHUNK 8 and with TPU.PALLAS_STEM_WGRAD_ONLY, whose K1/K2
   launches must equal their chunk schedules;
6. the speed path: the Slow-R50 speed-pretext step of
   configs/pretrain/SpeedPro_R50.yaml at full width on one card, uint8 clips
   through the 'simple' augmentation (the fused aug kernel), the lr from the
   port's lr policy, 2 warm-up and 5 timed steps, SyncBatchNorm's kernels
   launched exactly as its 54 BNs imply (statistics and fold 106 times a
   step, 52 of them recomputed under REMAT; sums and dx 54 times); then the
   BN kernels at each BN shape of the step against their plain versions on
   the same inputs (the card tests' tolerances), timed on the card's clock
   beside the plain versions and their byte bounds and summed over a step
   (``bn_forward``, ``bn_backward`` in the kernels line);
7. the masked path: the MViT-L MaskFeat + NT-Xent step of
   configs/pretrain/MViT_L_32x312_joint.yaml at full width and depth on one
   card (reversible, flash attention, AdamW with grad clipping), one video x
   2 views of uint8 clips through the 'OnlyCrop' augmentation, block masks
   from the port's MaskingGenerator3D, the lr from the port's lr policy in
   the warm-up, 2 warm-up and 5 timed steps; the flash kernels' launches
   are checked against the count the block schedule implies; then the same
   step with TPU.COMPUTE_DTYPE float32 (1 warm-up and 2 timed steps), whose
   attention runs K4's float32 pair as often as the bf16 step runs the bf16
   pair and never the bf16 pair;
7b. the AdViSe path: the AdViSe step of configs/pretrain/AdViSe.yaml
   (TemporalModel: a frozen ViT-B/16 CLIP tower with random weights from
   the seed, the R3D temporal head, speed CE) at full width on one card
   through build_train_state, 8 videos x 4 clips x 8 frames of uint8
   clips at 320x256 through the XLA simple aug, 2 warm-up and 5 timed
   steps: step time, clips/s, peak memory, parameter counts (total and
   frozen), then one step under torch.profiler (its device kernels by
   summed time, the idle share); the loss finite, the tower's digest unchanged, no kernel
   launched (the preset's path has none); then two variants of 1 warm-up
   and 2 timed steps: SSL.TASK speed_byol with TM.FROM_SCRATCH (the
   gradient through the whole tower; the tower and the BYOL twins move),
   and TPU.PALLAS_AUG, whose K3 launches must equal its steps; then AdViSe
   with the video_swin head (ADVISE_SWIN: its (8, 14, 14) token grid in
   windows of (4, 7, 7), the odd blocks shifted by (2, 3, 3)), the
   preset's speed task and speed_byol (the Swin layer's BYOL twin moves),
   2 warm-up and 5 timed steps each, no kernel launched;
7c. the X3D path: X3D-M's parameter count at 400 classes against the JAX
   package's, then the speed step of configs/pretrain/X3D_M_K400.yaml at
   full width on one card (16 videos x 4 clips x 16 frames of uint8 at
   320x256 through the XLA simple aug to 224^2, bf16, REMAT, simple_sgd),
   2 warm-up and 5 timed steps: step time, clips/s, peak memory, the
   convolutions' arithmetic rate; then each channelwise conv3d alone at
   the step's shapes (forward and backward, channels-last and NCDHW, CUDA
   events) and one step under torch.profiler (kernels by summed time, the
   idle share); no kernel launched; then TPU.PALLAS_AUG for 1 warm-up and 2
   timed steps, K3 once a step;
7d. the MoCo path: the contrastive step of
   configs/chip/moco_knn_minik400.yaml at its full width (Slow-R18 basic
   transform, 16 videos x 2 clips x 8 frames at 112^2 through the rbyol
   aug, shuffle-BN, the 256-key queue, SGD), 2 warm-up and 5 timed steps
   and 9 more, so that the queue's pointer wraps (checked each step); then
   the kNN probe with CONTRASTIVE.KNN_BATCH_STATS, which must leave the
   model's running statistics bit for bit; no kernel launched;
7e. the Swin path: Swin-B MoCo's parameter count against the JAX
   package's (90,002,504, built on the meta device), then the contrastive
   step of configs/pretrain/SwinB_moco_32chips.yaml at one card (Swin-B
   128 / 2-2-18-2 / 4-8-16-32, window (8, 7, 7), drop path 0.2; 4 videos x
   2 clips x 16 frames at 298x224 through rbyol to 224^2, bf16, shuffle-BN,
   the 65,536-key queue, the 239,975-row kNN bank on the card, LARS-SGD
   with ZERO_WD_1D_PARAM, momentum annealing), 2 warm-up and 5 timed
   steps: step time, clip-views/s, peak memory, the pointer advancing by
   4 a step, finite losses, one profiled step (kernels by summed time, the
   idle share), the kNN probe (the model bit for bit), and the window
   attention's float32 chain (scores, bias, mask, softmax, cast) alone at
   each block shape on CUDA events, as its share of the step; no kernel
   launched;
7f. the MAE path: the MAE step of configs/chip/mae_vismask_minik400.yaml
   at one card (MViT 96 wide, 8 blocks, 1 head; 16 clips x 8 frames of
   uint8 through OnlyCrop to 112^2, 784 of 3136 tokens visible at ratio
   0.75; the decoder 64 wide and 2 deep; bf16, AdamW; VIS_MASK's videos
   computed and dropped), 2 warm-up and 5 timed steps and one profiled
   step; then the same YAML at ViT-B/16 MAE widths (VITB_MAE: 768 wide, 12
   heads, 11 + 1 blocks, 2 x 16 x 16 patches of 16 frames at 224^2, 156 of
   1568 tokens visible at 0.9, the decoder 512 wide and 4 deep with
   separable position tables, 8 clips, VIS_MASK off), the same way; no
   kernel launched: the MAE blocks run the dense chain, as JAX's do;
7g. the rest of the contrastive engine and the solver: the BYOL preset's
   step at full width (16 videos x 2 clips x 32 frames at 224^2, REMAT,
   the 'aa' aug, K1 and K2) with CONTRASTIVE.TYPE simclr, swav (a
   3840-row queue full of unit rows at epoch 15: the loss's swav_gate
   stat open from the first step), mem 1d and mem 2d (DURATION 4, INTERP_MEMORY; the 65,536
   random rows of the preset's QUEUE_LEN a video), BYOL with
   CONTRASTIVE.SEQUENTIAL (its peak beside phase 5's batched step) and
   BYOL with AUG.TYPE clip_aug (CLIP_AUG_DYNAMICS), 2 warm-up and 3 timed
   steps each: median ms, peak memory, finite losses, moving parameters,
   and K1/K2 launches equal to each variant's schedule (CON_VARIANTS), and
   one more step of mem 1d, mem 2d and SEQUENTIAL under torch.profiler;
   then SpeedPro_R50.yaml with TRAIN.SEQUENTIAL (one of the 4 clips at a
   time, its peak beside phase 6's batched step, K3 once a step, one
   profiled step); then one
   step each of 'adam', LARS over AdamW and SOLVER.LAYER_DECAY 0.75 on
   configs/chip/mae_vismask_minik400.yaml, and the steps_with_relative_lrs
   lr at its boundaries;
7h. path (a), the op-exact RandAugment: the BYOL preset with AUG.FUSED_RA
   False, first the op-exact aug alone on the step's batch (16 videos x 2
   views x 32 frames at 298x224 -> 224^2, bicubic) against the fused aug
   alone, their times and peaks and the op-exact aug's time by stage, then
   2 warm-up and 3 timed steps and one profiled step, its time and peak
   against phase 5's, K1/K2 (2, 1) a step; path (c), ContrastiveModel over
   MViT: the BYOL preset's recipe (LARS-SGD, the fused 'aa' aug, 16 clips
   x 2 views, the momentum encoder) with MODEL.ARCH mvit and
   MViT_S_rev_masked.yaml's MVIT block at 16 frames of 224^2, reversible,
   flash attention (its head dims 96-768, the reference's head schedule
   not accumulating: K4 bf16 at all of them), under MoCo
   (BYOL needs a
   predictor, which MViT's head has not: JAX's byol_loss asserts), 2
   warm-up and 3 timed steps and one profiled step, K4's forward and
   backward launches equal to ``k4_schedule``;
8. the entry point: ``advise_tpu_torch.tools.run.main``, what ``python -m
   advise_tpu_torch.tools.run`` calls, run in this process with every
   launch count set to 0 before each run (``run_entry_point``), on the BYOL
   preset at full width with synthetic videos (48 of them: 3 iterations an
   epoch), one epoch with a kNN probe and a checkpoint, then the same
   command with 2 epochs and TRAIN.AUTO_RESUME, which must resume at epoch 1
   from Model_Epoch_0000 with the saved model bit for bit and run 3 more
   iterations (a torch.profiler window over two of them gives the device's
   idle share); checked: the files, finite losses, the step counter, the
   model's digests, the K1/K2 launches; then the SpeedPro preset through
   the same entry point, one epoch of 16 synthetic videos (2 iterations,
   a profiler window over the second), whose K3 launches must equal its
   iterations: iteration time, loader wait and idle share, then speed_val
   (PIPELINE ['train', 'speed_val'] at the VAL defaults: 40 clips a video,
   chunks of 2; its confusion matrix counts every clip, Metrics.csv, no
   kernel launched: clips/s, median batch, loader wait, peak memory); then
   configs/eval/linear_probe_ucf.yaml (Slow-R50, 101 classes, one card)
   through the same entry point with RESUME at the speed run's checkpoint:
   a linear probe of 2 iterations (the non-head parameters bit for bit the
   checkpoint's, the head trained), then action_infer over its 32 videos
   at 10 clips x 3 crops at 256^2 (views/s, median batch, loader wait, peak
   memory; no kernel launched); then the AdViSe
   preset the same way (16 videos, one epoch of 2 iterations, SSL.TASK
   speed_byol so that its checkpoint carries the BYOL twins): the
   TemporalModelingSampler's ingest at 320x256 and the XLA simple aug
   through the trainer, a profiler window over the second iteration; then
   X3D_M_K400.yaml (one epoch of 32 synthetic videos, 2 iterations, a
   profiler window over the second; no kernel launched); then
   configs/chip/moco_knn_minik400cc.yaml for one epoch of 32 synthetic
   videos with the kNN probe, and the same command to 2 epochs
   with TRAIN.AUTO_RESUME, whose model and SSL state (momentum encoder,
   queue, pointer, kNN bank) must start as saved, by their sha256; then
   SwinB_moco_32chips.yaml the same way (one card, 16 synthetic videos: 4
   iterations an epoch and the kNN probe), one epoch then a resume to 2,
   bit for bit by sha256; then AdViSe with the video_swin head, SSL.TASK
   speed_byol, one epoch of 2 iterations, the Swin layer's twin in its
   checkpoint; then mae_vismask_minik400.yaml for 2 epochs of 32
   synthetic videos and a resume to 3 (the model bit for bit by sha256),
   whose VIS_MASK dump must hold 4 triples an epoch, float32 [3, 4, 112,
   112, 3], with exactly 2352 hidden patches a clip and the reconstruction
   EQUAL to the input on every visible one; then
   configs/chip/maskfeat_minik400.yaml (the loader's block masks, HOG
   targets) for one epoch of 32 videos, and maskfeat_probe_minik400.yaml
   with RESUME at its checkpoint (a linear probe of 2 iterations that keeps
   the encoder bit for bit, then action_infer over 32 videos x 4 views); no
   kernel launched (no cv2, no dataset, no download); then the BYOL preset
   with CONTRASTIVE.TYPE swav (a 32-row queue) and with mem 2d (DURATION 4,
   INTERP_MEMORY), each one epoch of 32 synthetic videos from
   SOLVER.START_EPOCH 15 and a resume to a second, whose model and SSL
   state (the queue and swav_started, or the bank) must start as saved, by
   their sha256; K1/K2 by the schedule; SwAV's queue shut after the first
   epoch and open after the second (swav_started in the checkpoints, the
   loss's swav_gate stat in every iteration); then path (b):
   SpeedPro_R50.yaml with TPU.DEVICE_AUG False (the host aug in the
   loader's workers, its seconds in the run record's host stages, no K3),
   one epoch of 16 videos with a profiler window, and a resume to 2 bit
   for bit; one iteration of X3D_M_K400.yaml the same way; then path (c)
   through the entry point (one epoch of 32 videos, the kNN probe, a resume
   to 2 bit for bit, K4 by the schedule) and MViT_S_rev_masked.yaml the
   same way; then remote storage (``remote_entries``): path (c) with
   MVIT.REV.RESPATH_FUSE concat_linear_ln, its 32 videos uint8 .npy files
   in a local:// store (DATA.DATADIR; each clip through fetch_local into
   the media cache) and TRAIN.CHECKPOINT_REMOTE a local:// mirror, one
   epoch (the mirror exactly the local tree, its bytes printed), then the
   local checkpoints and the media cache removed and a resume to 2 from
   the mirror: the model and SSL state bit for bit, the best criteria as
   saved, no nested directory in the mirror, K4 by the schedule;
9. MViT-L through the entry point (ROADMAP A 7):
   configs/pretrain/MViT_L_32x312_joint.yaml at full width and depth
   (260,815,160 params: reversible, REMAT, bf16, AdamW, flash attention),
   one epoch of 2 synthetic videos (2 iterations of one video x 2 views,
   a profiler window over the second: iteration time, loader wait, idle
   share, peak) and a resume to 2, bit for bit by sha256; K4's forward and
   backward launches equal ``k4_schedule`` in each run;
10. data parallel on the BYOL preset at full width, 16 clips a rank, its
   sync groups cut to the 2 ranks: first NCCL asked to run two ranks on the
   one card (its answer printed: it refuses a device shared by two ranks);
   (i) two ranks on the one card through the entry point under
   ``torch.distributed.run`` with gloo, one epoch of 32 synthetic videos (1
   iteration and a kNN probe batch a rank) and a resume to 2: finite
   losses, equal stats and model and SSL digests on both ranks after each
   run, the resume from the saved state, K1/K2 (2, 1) a step and the
   probe's forward on each rank; (ii) on two gloo ranks, the fast
   pathway's first BN on its real input (the stem kernel's output of 16
   clips a rank), synced, against one BN over both ranks' rows within
   SYNCBN_Y_BOUND (output) and SYNCBN_DX_BOUND (input gradient), and
   all_gather_cat's gradient exactly the ranks' sum; (iii) one NCCL rank
   through the entry point against the same run in this process with no
   process group, both at lr 0 (every digest then depends on the forward
   only: the stem's max-pool backward adds with atomics, so no two
   processes' gradients agree bit for bit): the model and SSL digests at
   the start and the end, every loss and every launch count bit for bit.
   The two ranks share one card: this phase measures the semantics, not
   scaling;
11. the model-parallel layouts on MViT_L_32x312_joint.yaml at full width
   and depth in one ``torch.distributed.run`` of two gloo ranks on the one
   card (``--model-parallel``): (a) TPU.MESH_SEQ 2, (b) TPU.MESH_PIPE 2, (c)
   TPU.PARTITION_MODE 'auto' with MESH_MODEL 2, (d) 'auto' at data 2 with
   TPU.FSDP, each from TRAIN.SEED's weights at MVIT.DROPPATH_RATE 0, its
   first step against one rank's plain step (loss and grad norm within
   MP_LOSS_BOUND and MP_GNORM_BOUND; its time printed), then MP_TIMED timed
   steps (none: the script's time limit): step time, peak, the parameter
   and moment bytes a rank stores, the whole state's
   digest equal on both ranks, K4's launches equal ``k4_schedule`` of the
   layout (the ring launches none; a pipelined block once a tick), and
   every attention shape the layouts gave K4 (a pooled-KV block's q slice,
   a microbatch of one clip, half the heads) held against its plain
   version as phase 3 holds the others; the ring alone at RING_SHAPE
   against the dense chain within RING_BOUND; which of gloo's collectives
   take CUDA tensors. The script's wall time is printed last.

Reductions: one card (BN.NUM_SYNC_DEVICES 1, TPU.MESH_SYNC 1; shuffle-BN
permutes the card's own batch; Swin-B's preset is 32 chips), but phases 10
and 11, which run 2 ranks on the one card (phase 10 the BYOL preset's
8-card sync groups cut to them); widths, depth and per-card batches are the presets', but AdViSe's
video_swin head at 384 wide (the preset's 512 does not build in the JAX
package).

Each path's kernel launch counts are reset just before its steps and read
just after. In the steps of phases 5-7 every train-mode call of a
SyncBatchNorm of the model, or of its momentum encoder, is recorded, and
the BN kernels must run once a call (the sums once a call with a backward,
dx once a call whose input needs a gradient) with no layout copy; no
entry-point run may copy a BN input or gradient to channels-last. The line before the last is nvidia-smi's name and power limit;
the last is {"ok": true, "device": {...}}.
"""

import contextlib
import copy
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from collections import Counter

BYOL_CONFIG = "configs/pretrain/SlowFast_R50_K400.yaml"
SPEED_CONFIG = "configs/pretrain/SpeedPro_R50.yaml"
MASKED_CONFIG = "configs/pretrain/MViT_L_32x312_joint.yaml"
ADVISE_CONFIG = "configs/pretrain/AdViSe.yaml"
WARMUP_STEPS, TIMED_STEPS = 2, 5
LR, EPOCH_EXACT = 1e-3, 1.0
SPEED_EPOCH = 1.0  # inside SpeedPro's 10 warm-up epochs
MASKED_EPOCH = 1.0  # inside the MViT-L preset's 10 warm-up epochs
SLOW_R50_SPEED_PARAMS = 40_047_684  # the JAX package's oracle (tests/test_models.py)
VARIANT_WARMUP, VARIANT_TIMED = 1, 2  # the BYOL step's stem-schedule variants
F32_WARMUP, F32_TIMED = 1, 2  # the masked step in float32
# phase 8: the entry point on the BYOL preset, into a directory .gitignore lists
RUN_DIR = "build/chip_smoke_run"
RUN_VIDEOS = 48  # 3 iterations an epoch at the preset's 16 clips
RUN_KNN_BATCHES = 1  # kNN probe batches an epoch
RUN_OVERRIDES = ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(RUN_VIDEOS),
                 "TRAIN.SAVE_FREQ", "1", "CONTRASTIVE.KNN_EVAL_BATCHES", str(RUN_KNN_BATCHES)]
# then the speed preset through the entry point: one epoch of synthetic videos
SPEED_RUN_DIR = "build/chip_smoke_speed"
SPEED_RUN_VIDEOS = 16  # 2 iterations at the preset's 8 videos x 4 clips
SPEED_RUN_OVERRIDES = ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(SPEED_RUN_VIDEOS),
                       "SOLVER.MAX_EPOCH", "1", "TRAIN.AUTO_RESUME", "False",
                       "PIPELINE", "['train','speed_val']"]
# then the linear probe of configs/eval/linear_probe_ucf.yaml from the speed
# run's checkpoint, and multi-view inference (10 clips x 3 crops at 256^2)
PROBE_CONFIG = "configs/eval/linear_probe_ucf.yaml"
PROBE_RUN_DIR = "build/chip_smoke_probe"
PROBE_RUN_VIDEOS = 32  # 2 iterations at the preset's 16 clips
PROBE_RUN_OVERRIDES = ["NUM_GPUS", "1", "BN.NUM_SYNC_DEVICES", "1", "TPU.MESH_SYNC", "1",
                       "DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(PROBE_RUN_VIDEOS),
                       "SOLVER.MAX_EPOCH", "1", "RESUME", f"{SPEED_RUN_DIR}/checkpoints/Model_Epoch_0000"]
EVAL_SMALL_CLIPS = 2  # phase 4: the probe model's eval step, card against CPU
# then AdViSe through the entry point: one epoch of 2 iterations with the BYOL
# twins (SSL.TASK speed_byol), so its checkpoint carries them
ADVISE_RUN_DIR = "build/chip_smoke_advise"
ADVISE_RUN_VIDEOS = 16  # 2 iterations at the preset's 8 videos x 4 clips
ADVISE_RUN_OVERRIDES = ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(ADVISE_RUN_VIDEOS),
                        "SOLVER.MAX_EPOCH", "1", "SSL.TASK", "speed_byol", "TRAIN.AUTO_RESUME", "False"]
ADVISE_EPOCH = 1.0  # inside AdViSe's 5 warm-up epochs
ADVISE_SMALL_CLIPS = 2  # phase 4: clips x the preset's 8 frames at 224^2
# the AdViSe step's variants, VARIANT_WARMUP + VARIANT_TIMED steps each: the
# gradient through the whole ViT-B/16 with the BYOL twins moving, and the
# fused aug K3 in place of the XLA simple aug
ADVISE_VARIANTS = {"speed_byol FROM_SCRATCH": {"SSL.TASK": "speed_byol", "TM.FROM_SCRATCH": True},
                   "PALLAS_AUG": {"TPU.PALLAS_AUG": True}}
# the X3D path (phase 7c): X3D_M_K400.yaml's speed step at the preset's
# per-card batch; its phase-4 check on 2 clips of 16 frames at 112^2
X3D_CONFIG = "configs/pretrain/X3D_M_K400.yaml"
X3D_EPOCH = 1.0  # inside the preset's 10 warm-up epochs
X3D_M_PARAMS = 3_794_322  # X3D-M at 400 classes: the JAX package's oracle (tests/test_x3d.py)
SMALL_CLIPS, SMALL_SIZE = 2, 112  # phase 4's X3D and MoCo forwards
# the MoCo path (phase 7d): moco_knn_minik400.yaml's contrastive step; the
# steps after the timed ones run the pointer round the 256-row queue
MOCO_CONFIG = "configs/chip/moco_knn_minik400.yaml"
MOCO_CC_CONFIG = "configs/chip/moco_knn_minik400cc.yaml"
MOCO_EPOCH = 0.5  # inside the preset's warm-up epoch
# phase 8: X3D-M through the entry point, one epoch of 2 iterations
X3D_RUN_DIR = "build/chip_smoke_x3d"
X3D_RUN_VIDEOS = 32
ONE_CARD = ["NUM_GPUS", "1", "BN.NUM_SYNC_DEVICES", "1", "TPU.MESH_SYNC", "1"]
X3D_RUN_OVERRIDES = ONE_CARD + ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(X3D_RUN_VIDEOS),
                                "SOLVER.MAX_EPOCH", "1", "TRAIN.AUTO_RESUME", "False"]
# then moco_knn_minik400cc.yaml: one epoch of 32 videos (2 iterations and the
# kNN probe on batch statistics), then a resume to 2
MOCO_RUN_DIR = "build/chip_smoke_moco"
MOCO_RUN_VIDEOS = 32
MOCO_RUN_OVERRIDES = ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(MOCO_RUN_VIDEOS),
                      "TRAIN.SAVE_FREQ", "1"]
# the Swin path (phase 7e): SwinB_moco_32chips.yaml's MoCo step at one card,
# the preset's per-card batch; phase 4 checks Swin-B on one clip of 16
# frames at 112^2 (built for it: stage 4's 7 x 7 grid pads to 8 in
# PatchMerging and its window clamps to (8, 4, 4))
SWIN_CONFIG = "configs/pretrain/SwinB_moco_32chips.yaml"
SWIN_B_PARAMS = 90_002_504  # the JAX package's eval_shape of the preset (tests/test_torch_swin3d.py)
SWIN_EPOCH = 1.0  # inside the preset's 10 warm-up epochs
SWIN_SMALL_CLIPS, SWIN_SMALL_SIZE = 1, 112
# AdViSe with the video_swin temporal head (phase 7b), at the width the JAX
# package builds it: the head keeps TM.CHANNEL_POOL_DIM = TEMPORAL_EMBEDDING_DIM
ADVISE_SWIN = {"TM.TEMPORAL_ARCH": "video_swin", "MODEL.TEMPORAL_EMBEDDING_DIM": 384,
               "TM.CHANNEL_POOL_DIM": 384, "TM.NUM_HEADS": 6}
# phase 8: Swin-B MoCo through the entry point, one epoch of 16 videos (4
# iterations and the kNN probe), then a resume to 2; and AdViSe with the
# video_swin head, one epoch of 2 iterations of speed_byol
SWIN_RUN_DIR = "build/chip_smoke_swin"
SWIN_RUN_VIDEOS = 16
SWIN_RUN_OVERRIDES = ONE_CARD + ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(SWIN_RUN_VIDEOS),
                                 "TRAIN.SAVE_FREQ", "1"]
ADVISE_SWIN_RUN_DIR = "build/chip_smoke_advise_swin"
ADVISE_SWIN_RUN_OVERRIDES = ADVISE_RUN_OVERRIDES + [str(v) for kv in ADVISE_SWIN.items() for v in kv]
# the MAE path (phase 7f): mae_vismask_minik400.yaml's MAE step at one card
# (MViT 96 wide, 8 blocks, 1 head; 16 clips x 8 frames at 112^2, 784 of
# 3136 tokens visible; a decoder 64 wide and 2 deep; VIS_MASK on), then the
# same YAML at ViT-B/16 MAE widths (Feichtenhofer et al. 2022, "Masked
# Autoencoders As Spatiotemporal Learners"): 16 frames at 224^2 in 2 x 16 x
# 16 patches, 1568 tokens of which 156 visible at ratio 0.9, a decoder 512
# wide and 4 deep with separable position tables, 8 clips
MAE_CONFIG = "configs/chip/mae_vismask_minik400.yaml"
MAE_EPOCH = 0.5  # inside the preset's warm-up epoch
VITB_MAE = {"MVIT.EMBED_DIM": 768, "MVIT.NUM_HEADS": 12, "MVIT.DEPTH": 12, "MASK.PRETRAIN_DEPTH": [11],
            "MVIT.PATCH_KERNEL": [2, 16, 16], "MVIT.PATCH_STRIDE": [2, 16, 16], "MVIT.PATCH_PADDING": [0, 0, 0],
            "DATA.NUM_FRAMES": 16, "DATA.TRAIN_CROP_SIZE": 224, "DATA.TEST_CROP_SIZE": 224,
            "AUG.TARGET_SIZE": 224, "AUG.MASK_RATIO": 0.9, "MASK.DECODER_EMBED_DIM": 512,
            "MASK.DECODER_DEPTH": 4, "MASK.DECODER_SEP_POS_EMBED": True, "DATA.BATCHSIZE_PER_GPU": 8,
            "VIS_MASK.ENABLE": False}
MAE_VISIBLE = {"mae_vismask": (784, 3136), "ViT-B MAE": (156, 1568)}  # visible of all tokens a clip
MAE_SMALL_CLIPS = 2  # phase 4: the MAE model on 2 clips of its 8 frames at 112^2
# phase 4's MViTv2 forward: MViT_S_rev_masked.yaml's MViT-S trunk as a
# classifier with MViTv2's options on, 2 clips of 8 frames at 112^2
MVIT_S_CONFIG = "configs/pretrain/MViT_S_rev_masked.yaml"
MVIT_V2 = {"MODEL.MODEL_NAME": "MViT", "MASK.ENABLE": False, "MVIT.REL_POS_SPATIAL": True,
           "MVIT.REL_POS_TEMPORAL": True, "MVIT.RESIDUAL_POOLING": True, "MVIT.DIM_MUL_IN_ATT": True,
           "DATA.NUM_FRAMES": 8, "DATA.TRAIN_CROP_SIZE": 112, "DATA.TEST_CROP_SIZE": 112, "AUG.TARGET_SIZE": 112}
# phase 8: the MAE preset through the entry point, 2 epochs of 32 synthetic
# videos (2 iterations and a VIS_MASK dump of 4 clips each), then a resume to
# 3; then maskfeat_minik400.yaml (loader block masks, HOG) for one epoch and
# maskfeat_probe_minik400.yaml from its checkpoint (a linear probe of 2
# iterations, then action_infer over 32 videos x 4 views)
MAE_RUN_DIR = "build/chip_smoke_mae"
MAE_RUN_VIDEOS = 32
MAE_RUN_OVERRIDES = ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(MAE_RUN_VIDEOS),
                     "TRAIN.SAVE_FREQ", "1"]
MASKFEAT_CONFIG = "configs/chip/maskfeat_minik400.yaml"
MASKFEAT_RUN_DIR = "build/chip_smoke_maskfeat"
MASKFEAT_PROBE_CONFIG = "configs/chip/maskfeat_probe_minik400.yaml"
MASKFEAT_PROBE_RUN_DIR = "build/chip_smoke_maskfeat_probe"
MASKFEAT_RUN_VIDEOS = 32
# the synthetic videos' labels in the presets' 4 classes (the default 101
# would overrun the probe's 4-class head)
MASKFEAT_RUN_OVERRIDES = ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(MASKFEAT_RUN_VIDEOS),
                          "DATA.SYNTHETIC_NUM_CLASSES", "4", "TRAIN.SAVE_FREQ", "1", "SOLVER.MAX_EPOCH", "1",
                          "TRAIN.AUTO_RESUME", "False"]
MASKFEAT_PROBE_OVERRIDES = MASKFEAT_RUN_OVERRIDES + [
    "RESUME", f"{MASKFEAT_RUN_DIR}/checkpoints/Model_Epoch_0000"]
# the rest of the contrastive engine (phase 7g) on the BYOL preset at full
# width: each variant's overrides, its step's K1/K2 launches worked out from
# the code (the fast stem outside REMAT's checkpoints: K1 once a forward of
# the online model or the momentum encoder, K2 once a backward through the
# online one) and its loss's name. SimCLR and SwAV run the 2 views as one
# batch (VMAP_VIEWS), mem view 0 alone; CONTRASTIVE.SEQUENTIAL the keys of
# both views as one batch without a gradient, then each clip's query forward
# and backward; clip_aug is BYOL's step (online and momentum encoders)
CON_WARMUP, CON_TIMED = 2, 3
CLIP_AUG_DYNAMICS = {"AUG.CAMERA_SHAKE": 0.05, "AUG.CAMERA_SHIFT": 0.2, "AUG.ZOOM": 0.2, "AUG.COLOR_BRI": 0.3,
                     "AUG.COLOR_SAT": 0.3, "AUG.WHITE_BALANCE": 0.1}
CON_VARIANTS = [
    ("simclr", {"CONTRASTIVE.TYPE": "simclr"}, (1, 1), "loss_simclr"),
    ("swav", {"CONTRASTIVE.TYPE": "swav", "CONTRASTIVE.SWAV_QEUE_LEN": 3840}, (1, 1), "loss_swav"),
    ("mem 1d", {"CONTRASTIVE.TYPE": "mem"}, (1, 1), "loss_nce"),
    ("mem 2d interp", {"CONTRASTIVE.TYPE": "mem", "CONTRASTIVE.MEM_TYPE": "2d", "CONTRASTIVE.DURATION": 4,
                       "CONTRASTIVE.INTERP_MEMORY": True}, (1, 1), "loss_nce"),
    ("byol sequential", {"CONTRASTIVE.SEQUENTIAL": True}, (3, 2), "loss_byol"),
    ("byol clip_aug", {"AUG.TYPE": "clip_aug", **CLIP_AUG_DYNAMICS}, (2, 1), "loss_byol"),
]
SWAV_EPOCH = 15.0  # the SwAV queue's scores join the codes from this epoch on
# the variants given one more step under torch.profiler: where their time goes
CON_PROFILED = ("mem 1d", "mem 2d interp", "byol sequential")
# the solver's chains (phase 7g): one step each on the MAE preset
SOLVER_VARIANTS = [("adam", {"SOLVER.OPTIMIZING_METHOD": "adam"}),
                   ("LARS over AdamW", {"SOLVER.LARS_ON": True}),
                   ("layer decay 0.75", {"SOLVER.LAYER_DECAY": 0.75})]
# phase 8: SwAV and the 2-D memory bank through the entry point on the BYOL
# preset, 2 iterations an epoch from epoch 15 (SwAV's gate), one epoch and a
# resume to a second; SwAV's 32-row queue fills in the first epoch's two
# iterations and opens in the second epoch
CON_RUN_VIDEOS = 32
CON_RUN_OVERRIDES = ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(CON_RUN_VIDEOS),
                     "TRAIN.SAVE_FREQ", "1", "CONTRASTIVE.KNN_EVAL_BATCHES", str(RUN_KNN_BATCHES),
                     "SOLVER.START_EPOCH", "15"]
CON_ENTRIES = [("swav", "build/chip_smoke_swav", {"CONTRASTIVE.TYPE": "swav", "CONTRASTIVE.SWAV_QEUE_LEN": 32}),
               ("mem 2d", "build/chip_smoke_mem", {"CONTRASTIVE.TYPE": "mem", "CONTRASTIVE.MEM_TYPE": "2d",
                                                   "CONTRASTIVE.DURATION": 4, "CONTRASTIVE.INTERP_MEMORY": True})]
# the op-exact RandAugment (AUG.FUSED_RA False) on the BYOL preset: phase 4
# holds it on the card against the CPU on RA_SMALL_CLIPS clips of the
# preset's 32 frames at its ingest, each op alone, then the pipeline with
# the same draws; phase 7h times it alone against the fused aug on the
# step's batch, then the step (path (a))
RA_EXACT = {"AUG.FUSED_RA": False}
RA_SMALL_CLIPS = 2
RA_AUG_REPS = 3  # timed calls of each aug alone, after one warm-up
# phase 4: MViT_S_rev_masked.yaml's MViT-S trunk as a 400-class classifier
# with the A 20 knobs on, plain and reversible, flash attention (K4 by its
# route at each head dim), 2 clips of 8 frames at 112^2, bf16 on the card
# against float32 on the CPU
MVIT_KNOB_BASE = {"MODEL.MODEL_NAME": "MViT", "MASK.ENABLE": False, "TPU.FLASH_ATTENTION": True,
                  "DATA.NUM_FRAMES": 8, "DATA.TRAIN_CROP_SIZE": 112, "DATA.TEST_CROP_SIZE": 112,
                  "AUG.TARGET_SIZE": 112}
MVIT_KNOBS = [("plain", {"MVIT.MODE": "avg", "MVIT.SEPARATE_QKV": True, "MVIT.LAYER_SCALE_INIT_VALUE": 0.1,
                         "MVIT.NORM_STEM": True, "MVIT.DROPOUT_RATE": 0.1, "MVIT.HEAD_INIT_SCALE": 0.5,
                         "MVIT.PATCH_2D": True}),
              ("reversible", {"MVIT.REV.ENABLE": True, "MVIT.REV.RES_PATH": "max", "MVIT.POOL_FIRST": True,
                              "MVIT.MODE": "max", "MVIT.LAYER_SCALE_INIT_VALUE": 0.1, "MVIT.NORM_STEM": True})]
# ContrastiveModel over MViT (path (c)): the BYOL preset's recipe (LARS-SGD,
# the fused 'aa' aug, 16 clips x 2 views, the momentum encoder) with
# MODEL.ARCH mvit, MViT_S_rev_masked.yaml's MVIT block (mvit_s_block) at 16
# frames of 224^2, reversible, flash attention (head dims 96-768: the
# reference's head schedule does not accumulate; K4 bf16 at all of them,
# the two d-768 attentions on its width-768 kernels). CONTRASTIVE.TYPE
# moco: MViT's head carries no
# predictor, so BYOL raises in both packages (JAX's byol_loss asserts)
MVIT_CON = {"MODEL.ARCH": "mvit", "CONTRASTIVE.TYPE": "moco", "DATA.NUM_FRAMES": 16, "DATA.TRAIN_CROP_SIZE": 224,
            "DATA.TEST_CROP_SIZE": 224, "MVIT.REV.ENABLE": True, "TPU.FLASH_ATTENTION": True}
# phase 8: SpeedPro_R50.yaml with TPU.DEVICE_AUG False (the host aug in the
# loader, no K3): one epoch of 16 synthetic videos, then a resume to 2; then
# one iteration of X3D_M_K400.yaml the same way
HOST_AUG_RUN_DIR = "build/chip_smoke_host_aug"
HOST_AUG_OVERRIDES = ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(SPEED_RUN_VIDEOS),
                      "TRAIN.SAVE_FREQ", "1", "TPU.DEVICE_AUG", "False"]
X3D_HOST_AUG_RUN_DIR = "build/chip_smoke_x3d_host_aug"
# then ContrastiveModel over MViT (MVIT_CON) for one epoch of 32 synthetic
# videos (2 iterations and the kNN probe) and a resume to 2; then
# MViT_S_rev_masked.yaml itself (ROADMAP A 7) the same way
MVIT_CON_RUN_DIR = "build/chip_smoke_mvit_con"
MVIT_S_RUN_DIR = "build/chip_smoke_mvit_s"
MVIT_RUN_VIDEOS = 32
MVIT_RUN_OVERRIDES = ONE_CARD + ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(MVIT_RUN_VIDEOS),
                                 "TRAIN.SAVE_FREQ", "1", "CONTRASTIVE.KNN_EVAL_BATCHES", str(RUN_KNN_BATCHES)]
# phase 4: MViT_S_rev_masked.yaml's MaskMViT made reversible (the preset
# runs the plain walk), MASK.PRETRAIN_DEPTH at its last block, which ends a
# segment, with MVIT.REV.RESPATH_FUSE concat_linear_ln, so that the features
# come out of fuse_inter's float32 projection and LayerNorm; flash attention
# (K4 by its route), 2 clips of 8 frames at 112^2 with the loader's block
# masks, bf16 on the card against float32 on the CPU
FUSE_INTER = {"MVIT.REV.ENABLE": True, "MVIT.REV.RESPATH_FUSE": "concat_linear_ln", "TPU.FLASH_ATTENTION": True,
              "DATA.NUM_FRAMES": 8,
              "DATA.TRAIN_CROP_SIZE": 112, "DATA.TEST_CROP_SIZE": 112, "AUG.TARGET_SIZE": 112}
# phase 8: path (c) (MVIT_CON) with MVIT.REV.RESPATH_FUSE concat_linear_ln
# on remote storage: REMOTE_VIDEOS uint8 .npy videos of REMOTE_FRAMES frames
# at the preset's ingest size in a local:// store (every clip through
# utils/storage.py fetch_local into the media cache under REMOTE_ROOT),
# TRAIN.CHECKPOINT_REMOTE a second local:// directory; one epoch, then the
# local checkpoints and the media cache removed and a resume to 2 that must
# come from the mirror
REMOTE_ROOT = "build/chip_smoke_remote_store"
REMOTE_RUN_DIR = "build/chip_smoke_remote"
REMOTE_VIDEOS, REMOTE_FRAMES = 32, 40
REMOTE_FUSE = {"MVIT.REV.RESPATH_FUSE": "concat_linear_ln"}
# phase 9: MViT_L_32x312_joint.yaml through the entry point at full width
# and depth (ROADMAP A 7): one epoch of 2 synthetic videos (the preset's one
# video a card: 2 iterations, a profiler window over the second), then a
# resume to 2
MVIT_L_RUN_DIR = "build/chip_smoke_mvit_l"
MVIT_L_RUN_VIDEOS = 2
MVIT_L_RUN_OVERRIDES = ONE_CARD + ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(MVIT_L_RUN_VIDEOS),
                                   "TRAIN.SAVE_FREQ", "1"]
# phase 10: data parallel on the BYOL preset (its BN.NUM_SYNC_DEVICES 8 and
# TPU.MESH_SYNC 8 cut to the 2 ranks: one sync group), 16 clips a rank:
# (i) 2 ranks on the one card through the entry point under
# torch.distributed.run (gloo: NCCL refuses two ranks on one device), one
# epoch of 64 synthetic videos (2 iterations and a kNN probe batch a rank),
# then a resume to 2; (ii) SyncBN and all_gather_cat across the 2 ranks on
# the fast pathway's first BN input; (iii) one NCCL rank against the
# single-process run, both at lr 0 (every digest a function of the forward:
# the stem's max-pool backward adds with atomics, so gradients are not
# bit-reproducible across processes)
DP_RUN_DIR = "build/chip_smoke_dp"
DP_RANKS = 2
DP_RUN_VIDEOS = 32  # (i): 1 iteration a rank an epoch
DP_OVERRIDES = ["DATA.DECODE_BACKEND", "synthetic", "DATA.SYNTHETIC_SIZE", str(DP_RUN_VIDEOS), "TRAIN.SAVE_FREQ", "1",
                "CONTRASTIVE.KNN_EVAL_BATCHES", str(RUN_KNN_BATCHES)]
DP_SINGLE_VIDEOS = 16  # (iii): 1 iteration of one rank
DP_LR0 = ["SOLVER.BASE_LR", "0.0", "SOLVER.WARMUP_START_LR", "0.0", "SOLVER.COSINE_END_LR", "0.0"]
DP_TIMEOUT_S = 420  # a torchrun job that outlives this is killed, and the phase fails
# (ii)'s bounds: the bf16 BN output one bf16 ulp (2^-7) of its largest value
# apart from one BN over both ranks' batch; the input gradient 2^-6
SYNCBN_Y_BOUND, SYNCBN_DX_BOUND = 2.0 ** -7, 2.0 ** -6
# a run whose checkpoints nothing reads writes none: the card's machine caps
# what the script writes to its disk (45 GiB, deleted files included), and a
# MViT-L checkpoint with AdamW's moments is 3.1 GB
NO_SAVE = ["TRAIN.SAVE_FREQ", "0"]
# phase 11: the model-parallel layouts on MViT_L_32x312_joint.yaml at full
# width and depth, two gloo ranks on the one card in one torchrun: (a)
# TPU.MESH_SEQ 2, (b) TPU.MESH_PIPE 2, (c) PARTITION_MODE 'auto' with
# MESH_MODEL 2, (d) 'auto' with data 2 and TPU.FSDP, each from the same
# initial state (TRAIN.SEED), 1 video x 2 views a rank (in (a)-(c) the same
# video on both ranks, in (d) one each), MVIT.DROPPATH_RATE 0 (a rank of
# (d) draws its masks from its own batch index's generator, one rank over
# both videos from one), clips and loader masks from numpy's seed; then the ring alone at [2, 8, 6400, 72] bf16 over the two ranks.
# The comparisons, a step each, against one rank's plain step (run as
# MESH_SEQ 2 with MVIT.SEQ_SHARD False: each rank alone in its batch group,
# the same step on both): (a)-(c) on the same video (a data-parallel pair
# would add the duplicate video to the joint NT-Xent's negatives); (d) on
# both videos at once ("plain_both"), and against 'auto' at data 2 without
# FSDP (the same global-batch loss). A reference: (overrides, the videos it
# takes: "first", "own" (the rank's) or "both")
MP_RUN_DIR = "build/chip_smoke_mp"
MP_RANKS = 2
MP_LAYOUTS = {"a": {"TPU.MESH_SEQ": 2}, "b": {"TPU.MESH_PIPE": 2},
              "c": {"TPU.PARTITION_MODE": "auto", "TPU.MESH_MODEL": 2},
              "d": {"TPU.PARTITION_MODE": "auto", "TPU.FSDP": True}}
MP_PLAIN = {"TPU.MESH_SEQ": 2, "MVIT.SEQ_SHARD": False}
MP_REFERENCES = {"plain": (MP_PLAIN, "first"), "plain_both": (MP_PLAIN, "both"),
                 "auto_data": ({"TPU.PARTITION_MODE": "auto"}, "own")}
MP_REFERENCE = {"a": ("plain",), "b": ("plain",), "c": ("plain",), "d": ("plain_both", "auto_data")}
MP_TIMED = 0  # timed steps after the compared first one (its own time is printed)
MP_LR = 1e-3
MP_TIMEOUT_S = 600
# bounds of the first step's stats against a reference (relative, a loss to
# max(|loss|, 1e-2): the joint NT-Xent of one video is 0): bf16 sums over
# 'model', the ring's float32 state and a batch split over ranks reassociate
# what one rank sums in one matmul. The bounds sit a few times above the
# largest readings on an H100 (losses 1.6e-4, grad norm 3.2e-4)
MP_LOSS_BOUND, MP_GNORM_BOUND = 2e-3, 5e-3
RING_SHAPE = (2, 8, 6400, 72)
RING_BOUND = 2.0 ** -6  # of the dense chain's largest value: a few bf16 ulps of the output
# the pl.pallas_call of each Mosaic probe in scripts/probe_mosaic_aot.py
PROBE_LINES = {"lead_dyn": 76, "sub_dyn": 99, "sub_aligned": 123, "val_dslice": 138,
               "roll_dyn": 153, "aug_like": 180, "aug_like_aligned": 207, "roll_lane": 236,
               "flat_u8": 263}

K4_REPS = 10  # flash attention and SDPA calls back to back in a timing sample
AUG_REPS = 10  # fused aug calls back to back in a timing sample
SLEEP_CYCLES = 10_000_000  # ~5 ms at 1980 MHz: the card waits while the host queues a sample
BN_REPS = 5  # BN kernel calls a queued sample (the stem's backward: ~0.74 ms each)
GATHER_LAUNCHES = 100  # window_gather launches back to back in a timing sample
AUG_ALL_ON = (1.0, 0.4, 0.4, 0.4, 0.2)  # every clip runs the chain
# K3's edge shapes (those of tests/test_torch_kernels_cuda.py): (clips, crop,
# tops, lefts): W*3 = 129 with an odd crop, tops not 8-aligned and bands 15 +
# 14; N*T = 1 with S % 4 == 2 and bands 13 + 13 + 12; left at 0 and at W - S
# with top at H - S (the window ends on the tensor's last byte); W*3 = 135
# (every row at its own shift); one pixel; the largest exact crop, 256
AUG_EDGE_SHAPES = [((3, 2, 37, 43, 3), 29, (3, 5, 7), None), ((1, 1, 40, 52, 3), 38, (1,), (5,)),
                   ((2, 3, 50, 61, 3), 45, (0, 5), (0, 16)), ((2, 2, 36, 45, 3), 32, (1, 4), (13, 2)),
                   ((2, 2, 5, 7, 3), 1, (4, 0), (6, 3)), ((1, 2, 256, 260, 3), 256, (0,), (4,))]

# H100 SXM (NVIDIA's data sheet): device memory rate, dense bf16 tensor
# cores, float32 on the CUDA cores, and float32 as 3xTF32 on the tensor
# cores (three dense TF32 MMAs, 495 TFLOP/s, per float32 product)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "tf32x3": 495e12 / 3}
# float operations of the fused aug per output element: the luma (5), the
# three blends (5 each) and the normalisation lookup, rounded up
AUG_OPS_PER_ELEMENT = 25


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def card_state() -> str:
    """The card's SM clock now and at most, power draw and temperature: a
    card held below its clock shows here, as its times will."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def one_card_cfg(tconfig, path, overrides=None):
    """``path`` at one card (NUM_WORLDS, TPU.MESH_SYNC, BN.NUM_SYNC_DEVICES
    1), with ``overrides`` {KEY: value}."""
    cfg = tconfig.get_cfg()
    cfg.merge_from_file(path)
    cfg.NUM_WORLDS = 1
    cfg.TPU.MESH_SYNC = 1
    cfg.BN.NUM_SYNC_DEVICES = 1
    for key, value in (overrides or {}).items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        node[leaf] = value
    return tconfig.assert_and_infer_cfg(cfg)


def as_argv(overrides) -> list:
    """{KEY: value} as the entry point's KEY VALUE arguments (Python
    literals)."""
    return [str(x) for item in overrides.items() for x in item]


def mvit_s_block() -> dict:
    """The MVIT options MViT_S_rev_masked.yaml sets, as {MVIT.KEY: value}."""
    import yaml

    with open(MVIT_S_CONFIG) as f:
        return {f"MVIT.{k}": v for k, v in yaml.safe_load(f)["MVIT"].items()}


def mvit_con_cfg(tconfig):
    """Path (c)'s configuration: the BYOL preset at one card with MVIT_CON
    and MViT-S's block."""
    return one_card_cfg(tconfig, BYOL_CONFIG, {**mvit_s_block(), **MVIT_CON})


def mvit_attentions(mvit):
    """Each attention of an MViT in block order, with whether the backward
    always runs its forward again: (attn, True) for a reversible block's F
    (the reversible walk), (attn, False) for a transition or a plain block
    (again only under REMAT, its checkpoint)."""
    for item in mvit.plan:
        if item[0] == "segment":
            for sub in getattr(mvit, f"rev_seg{item[1]}_f"):
                yield sub.attn, True
        else:
            yield getattr(mvit, f"blocks_{item[1]}").attn, False


def k4_schedule(mvit, remat: bool, forwards_without_grad: int, backward: bool = True, seq: int = 1,
                thw=None, pipe: int = 1, n_micro: int = 1) -> dict:
    """K4's launches a step of an MViT trained once a step, by kernel
    (``flash_mha_fwd``/``_bwd``, the bf16 pair, or the float32 pair
    ``flash_f32_fwd``/``_bwd`` for a head dim above 768: ``route``), worked
    out from the code: each attention launches the forward in its forward
    pass; the backward recomputes every reversible block's F (the
    reversible walk) and, under REMAT, every transition (its checkpoint);
    each forward without a gradient (the momentum encoder's keys) launches
    once more; the backward launches once an attention. ``backward`` False:
    a forward without a gradient alone (an eval forward, a kNN probe batch:
    ``forwards_without_grad`` 0), once an attention, nothing recomputed.

    A rank of a model-parallel layout: ``seq`` > 1 (TPU.MESH_SEQ, the
    blocks' ``thw`` grid given): an attention of the sequence-parallel
    branch whose q and k hold as many tokens (which ``seq`` divides) goes
    round the ring and launches no K4; a pooled-KV one launches K4 on its q
    slice, once, as without the split. ``pipe`` > 1 (TPU.MESH_PIPE, with
    ``n_micro`` microbatches): a reversible segment whose length ``pipe``
    divides runs a stage's L / pipe blocks once a tick over n_micro + pipe
    - 1 ticks, forward, recompute and backward alike."""
    from advise_tpu_torch.ops.flash_attention import route

    import torch

    out = {name: 0 for name in ("flash_mha_fwd", "flash_mha_bwd", "flash_f32_fwd", "flash_f32_bwd")}
    shapes = mvit_attention_shapes(mvit, thw, 1) if seq > 1 else None
    ticks = n_micro + pipe - 1
    index = 0
    for item in mvit.plan:
        if item[0] == "segment":
            subs = [(sub.attn, True) for sub in getattr(mvit, f"rev_seg{item[1]}_f")]
        else:
            subs = [(getattr(mvit, f"blocks_{item[1]}").attn, False)]
        piped = pipe > 1 and item[0] == "segment" and len(subs) % pipe == 0
        times = ticks if piped else 1
        for attn, reversible in subs[: len(subs) // pipe] if piped else subs:
            nq, nk = (shapes[index][2], shapes[index][3]) if shapes else (0, 1)
            index += 1
            if shapes and attn.seq_axis and nq == nk and nq % seq == 0:
                continue  # the ring
            recompute = 1 if backward and (reversible or remat) else 0
            pair = "flash_mha" if route(torch.bfloat16, attn.dim_out // attn.num_heads) == "wgmma" else "flash_f32"
            out[f"{pair}_fwd"] += times * (1 + recompute + forwards_without_grad)
            out[f"{pair}_bwd"] += times * (1 if backward else 0)
        if piped:
            index += len(subs) - len(subs) // pipe
    return out


def head_dims(mvit) -> list:
    """Each attention's head dim in block order (reversible or plain walk)."""
    return [attn.dim_out // attn.num_heads for attn, _ in mvit_attentions(mvit)]


def plan_model(cfg):
    """``cfg``'s model on the meta device: its structure, attention plan
    and parameter shapes, with no weights drawn."""
    import torch

    from advise_tpu_torch.models import MODEL_REGISTRY, compute_dtype
    from advise_tpu_torch.models.layers.norm import get_norm

    with torch.device("meta"):
        return MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg, get_norm(cfg), compute_dtype(cfg))


def path_c_shapes(tconfig) -> list:
    """Path (c)'s attention shapes at full width: the MViT-S of
    ``mvit_con_cfg`` (``plan_model``), one view's clips a call (the online
    forward and the keys each take one view)."""
    from advise_tpu_torch.models.mvit import patch_grid

    cfg = mvit_con_cfg(tconfig)
    return mvit_attention_shapes(plan_model(cfg).backbone, patch_grid(cfg), cfg.DATA.BATCHSIZE_PER_GPU)


def mvit_attention_shapes(mvit, thw, batch: int) -> list:
    """(b, heads, nq, nk, head_dim) of each attention of a built MViT in
    block order, from its own pooling kernels and strides, for a ``thw``
    patch grid and ``batch`` clips a call."""
    from advise_tpu_torch.models.mvit import pooled_thw

    shapes = []
    for attn, _ in mvit_attentions(mvit):
        q_thw = pooled_thw(thw, attn.kernel_q, attn.stride_q) if attn.kernel_q else tuple(thw)
        kv_thw = pooled_thw(thw, attn.kernel_kv, attn.stride_kv) if attn.kernel_kv else tuple(thw)
        cls = int(attn.has_cls_embed)
        shapes.append((batch, attn.num_heads, math.prod(q_thw) + cls, math.prod(kv_thw) + cls,
                       attn.dim_out // attn.num_heads))
        thw = q_thw
    return shapes


def attention_shapes(cfg, batch: int):
    """(b, heads, nq, nk, head_dim) of each block's attention in the
    reversible MViT encoder of ``cfg``, in block order."""
    from advise_tpu_torch.models.mvit import mvit_block_schedule, patch_grid, pooled_thw

    thw = patch_grid(cfg)
    schedule, _ = mvit_block_schedule(cfg, thw)
    shapes = []
    for spec in schedule[: cfg.MASK.PRETRAIN_DEPTH[-1] + 1]:
        q_thw = pooled_thw(thw, spec["kernel_q"], spec["stride_q"])
        kv_thw = pooled_thw(thw, spec["kernel_kv"], spec["stride_kv"])
        shapes.append((batch, spec["num_heads"], math.prod(q_thw), math.prod(kv_thw),
                       spec["dim_out"] // spec["num_heads"]))
        thw = q_thw
    return shapes


def k4_against_plain(fl, shape, dev, g):
    """K4's bf16 pair at ``shape`` (b, heads, nq, nk, head_dim) on random
    inputs from ``g`` against ``flash_mha_plain`` in float32: the output
    within 2^-7 and dq, dk, dv within 2^-6 of the plain version's largest
    value (the card tests' reasoning), the backward bit for bit again.
    Returns the largest error by kernel, and the inputs, the kernel's
    forward and the plain output (for timing)."""
    import torch

    b_, h_, nq, nk, d = shape
    scale = d ** -0.5
    q = torch.randn((b_, h_, nq, d), device=dev, generator=g).bfloat16()
    k_, v = (torch.randn((b_, h_, nk, d), device=dev, generator=g).bfloat16() for _ in range(2))
    do = torch.randn((b_, h_, nq, d), device=dev, generator=g).bfloat16()
    o, lse = fl.flash_mha_fwd(q, k_, v, scale)
    dq, dk, dv = fl.flash_mha_bwd(q, k_, v, o, lse, do, scale)
    qr, kr, vr = (t.float().requires_grad_() for t in (q, k_, v))
    ref = fl.flash_mha_plain(qr, kr, vr, scale)
    grads = torch.autograd.grad(ref, (qr, kr, vr), do.float(), retain_graph=True)
    torch.cuda.synchronize()
    pairs = {"o": (o, ref.detach(), 2 ** -7)}
    pairs.update({f"d{n}": (a, r, 2 ** -6) for n, a, r in zip("qkv", (dq, dk, dv), grads)})
    errs, said, off = {"flash_mha_fwd": 0.0, "flash_mha_bwd": 0.0}, [], []
    for name, (a, r, tol) in pairs.items():
        err = float((a.float() - r).abs().max())
        top = float(r.abs().max())
        said.append(f"{name} {err} (bound {tol} of max|ref| {top} = {tol * top})")
        if not (math.isfinite(err) and err <= tol * top):
            off.append(name)
        key = "flash_mha_fwd" if name == "o" else "flash_mha_bwd"
        errs[key] = max(errs[key], err)
    print(f"[kernel] flash {shape} max_abs_err: {', '.join(said)}")
    check(not off, f"flash attention {off} disagrees at {shape}")
    again = fl.flash_mha_bwd(q, k_, v, o, lse, do, scale)
    check(all(torch.equal(a, bb) for a, bb in zip(again, (dq, dk, dv))),
          "flash attention backward is not deterministic")
    return errs, (q, k_, v, do, o, lse, qr, kr, vr, ref)


def sdpa_backend(q, k, v, scale):
    """The first scaled_dot_product_attention backend that takes these
    inputs, in the dispatcher's order of preference."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal warns its reason
                F.scaled_dot_product_attention(q, k, v, scale=scale)
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("chip_smoke: no SDPA backend takes these inputs")


def bound(nbytes: float, ops: float, kind: str):
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stem_schedules(sc, x, w, y, gy, kt, alone, results) -> None:
    """K1' (K1 and K2 once per batch chunk, TPU.PALLAS_STEM_CHUNK) at chunk 8
    and 12 (-> 8, the largest divisor of the batch below it) and K2' (K2 over
    WGRAD_CHUNK-sample chunks, TPU.PALLAS_STEM_WGRAD_ONLY) at the BYOL stem
    shape, against the plain versions with K1's and K2's bounds; their plain
    and library times are K1's and K2's of this run (the same functions)."""
    import torch

    ref = sc.stem_conv_plain(x.float(), w.float())
    dref = sc.stem_wgrad_plain(x, gy, kt)
    torch.cuda.synchronize()
    top, wg_top = float(ref.abs().max()), float(dref.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    n = x.shape[0]
    for chunk in (8, 12):
        cb = sc.largest_divisor(n, chunk)
        yc = sc.stem_conv_fwd_chunked(x, w, cb)
        dwc = sc.stem_conv_wgrad_chunked(x, gy, kt, cb)
        torch.cuda.synchronize()
        f_err = float((yc.float() - ref).abs().max())
        w_err = float((dwc - dref).abs().max())
        print(f"[kernel] K1' chunk {chunk} -> {cb} ({n // cb} launches each way): fwd max_abs_err "
              f"{f_err} (bound {ulp}), bit-equal to one K1 launch {torch.equal(yc, y)}; wgrad "
              f"max_abs_err {w_err} (bound 1e-3 * max|dW| = {1e-3 * wg_top})")
        check(math.isfinite(f_err) and f_err <= ulp, f"chunked stem forward disagrees at chunk {chunk}")
        check(torch.equal(yc, y), f"the chunked stem forward at chunk {chunk} differs from one K1 launch")
        check(math.isfinite(w_err) and w_err <= 1e-3 * wg_top,
              f"chunked stem weight gradient disagrees at chunk {chunk}")
        if chunk == 8:
            fwd, wg = results["stem_conv_fwd"], results["stem_conv_wgrad"]
            results["stem_conv_fwd_chunked"] = dict(
                fwd, max_abs_err=f_err, ms=alone(lambda: sc.stem_conv_fwd_chunked(x, w, cb)))
            results["stem_conv_wgrad_chunked"] = dict(
                wg, max_abs_err=w_err, ms=alone(lambda: sc.stem_conv_wgrad_chunked(x, gy, kt, cb)))
    cb = sc.largest_divisor(n, sc.WGRAD_CHUNK)
    dwo = sc.stem_conv_wgrad_chunked(x, gy, kt, cb)
    torch.cuda.synchronize()
    o_err = float((dwo - dref).abs().max())
    print(f"[kernel] K2' wgrad-only backward, {cb}-sample chunks ({n // cb} launches): max_abs_err "
          f"{o_err} (bound {1e-3 * wg_top})")
    check(math.isfinite(o_err) and o_err <= 1e-3 * wg_top, "wgrad-only stem gradient disagrees")
    results["stem_conv_wgrad_only"] = dict(
        results["stem_conv_wgrad"], max_abs_err=o_err,
        ms=alone(lambda: sc.stem_conv_wgrad_chunked(x, gy, kt, cb)))
    for name in ("stem_conv_fwd_chunked", "stem_conv_wgrad_chunked", "stem_conv_wgrad_only"):
        r = results[name]
        print(f"[kernel] {name}: {r['ms']} ms, plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound'][0]} ms ({r['bound'][1]})")


def tf32_mma_counts(lib_path, nvcc):
    """{kernel (mangled): TF32 tensor-core instructions (HMMA...TF32 of
    mma.sync, HGMMA...TF32 of wgmma)} in the SASS of a built library, from
    the toolkit's cuobjdump."""
    from pathlib import Path

    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = line.split("Function : ", 1)
        if len(head) == 2:
            fn = head[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line) and "TF32" in line:
            counts[fn] += 1
    return counts


def flash_f32_table(fl, build, dev, g, uses, per_block, in_turns, alone, sms):
    """K4's float32 pair at every distinct attention shape of the masked
    path's encoder in float32 (2 views), each weighted by the blocks that run
    it, then at (1,3,777,555,640) float32 and (1,2,500,300,800) bf16 (what
    the bf16 kernels do not take): its
    plan, registers and spills (a spill in a float32 instance, which serves
    head dims up to 288, fails), the TF32 MMAs of its SASS (none fails),
    agreement with the plain versions (float32: 1e-4 of the largest entry;
    bf16: 2^-7), a deterministic backward, and times beside the plain chain,
    SDPA in the same dtype, the CUDA-core float32 bound and the 3xTF32 bound.
    Returns the encoder's totals as flash_f32_fwd / flash_f32_bwd results."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    for (kname, dtype, cw, bk), use in sorted(fl.f32_kernel_usage().items(), key=str):
        print(f"[kernel] flash f32 pair {kname} {dtype}" + (f" CW {cw} BK {bk}" if cw else "")
              + f": {use['registers']} registers, spill stores {use['spill_stores']} B, loads "
              f"{use['spill_loads']} B")
        if dtype == "float32":
            check(use["spill_stores"] == use["spill_loads"] == 0,
                  f"flash f32 pair {kname} CW {cw} spills registers")
    counts = tf32_mma_counts(build.library_path(fl.SOURCE_F32), build.find_nvcc())
    for name, n in sorted(counts.items()):
        print(f"[kernel] flash f32 pair SASS {name[-70:]}: {n} TF32 MMA instructions")
    for kname in ("flash_f32_fwd_kernel", "flash_f32_dkdv_kernel", "flash_f32_dq_kernel"):
        n = sum(c for name, c in counts.items() if kname in name)
        check(n > 0, f"{kname} has no TF32 tensor-core instruction in its SASS")
    totals = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound=[0.0, 0.0], max_abs_err=0.0)
              for name in ("flash_f32_fwd", "flash_f32_bwd")}
    cases = [(sh, torch.float32) for sh in sorted(uses, key=lambda sh: -uses[sh])]
    cases += [((1, 3, 777, 555, 640), torch.float32), ((1, 2, 500, 300, 800), torch.bfloat16)]
    for shape, dtype in cases:
        b_, h_, nq, nk, d = shape
        check(fl.route(dtype, d) == "f32", f"flash {shape} {dtype} does not route to the float32 pair")
        fplan = fl.f32_plan(b_ * h_, nq, nk, d, dtype == torch.bfloat16)
        print(f"[kernel] flash f32 pair {shape} {dtype}: " + ", ".join(
            f"{kname} grid {kp['grid']} ({math.prod(kp['grid']) / sms} blocks an SM)"
            + (f", {kp['warps']} warps, CW {kp['cw']}, {'streamed' if kp['stream'] else 'resident'}, "
               f"{kp['smem']} B shared" if "cw" in kp else "")
            for kname, kp in fplan.items() if isinstance(kp, dict))
            + f"; dK/dV splits {fplan['splits']} (scratch {fplan['scratch_bytes']} B)")
        scale = d ** -0.5
        q, do = (torch.randn((b_, h_, nq, d), device=dev, generator=g).to(dtype) for _ in range(2))
        k_, v = (torch.randn((b_, h_, nk, d), device=dev, generator=g).to(dtype) for _ in range(2))
        before = (fl.flash_mha_fwd.launches, fl.flash_mha_bwd.launches,
                  fl.flash_f32_fwd.launches, fl.flash_f32_bwd.launches)
        o, lse = fl.flash_mha_fwd(q, k_, v, scale)
        grads = fl.flash_mha_bwd(q, k_, v, o, lse, do, scale)
        ref_o, ref_lse = fl.flash_fwd_plain(q, k_, v, scale)
        ref_g = fl.flash_bwd_plain(q, k_, v, o, lse, do, scale)
        torch.cuda.synchronize()
        check((fl.flash_mha_fwd.launches, fl.flash_mha_bwd.launches, fl.flash_f32_fwd.launches,
               fl.flash_f32_bwd.launches) == (before[0], before[1], before[2] + 1, before[3] + 1),
              f"flash {shape} {dtype} did not launch the float32 pair once each way")
        # float32: 3xTF32 products (about 2^-22 of each) summed in float32 in
        # another order (1e-4 of the largest entry); bf16: both round the
        # same float32 values to bf16 (one ulp, 2^-7)
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7
        for name, a, r in (("o", o, ref_o), ("dq", grads[0], ref_g[0]), ("dk", grads[1], ref_g[1]),
                           ("dv", grads[2], ref_g[2])):
            err = float((a.float() - r.float()).abs().max())
            top = float(r.float().abs().max())
            print(f"[kernel] flash f32 pair {shape} {dtype} {name}: max_abs_err {err} (bound {tol} of "
                  f"max|ref| {top} = {tol * top})")
            check(math.isfinite(err) and err <= tol * top, f"flash f32 pair {name} disagrees at {shape}")
            if dtype == torch.float32 and shape in uses:
                key = "flash_f32_fwd" if name == "o" else "flash_f32_bwd"
                totals[key]["max_abs_err"] = max(totals[key]["max_abs_err"], err)
        del ref_o, ref_g
        lse_err = float((lse - ref_lse).abs().max())
        print(f"[kernel] flash f32 pair {shape} {dtype} lse: max_abs_err {lse_err} (bound 1e-4)")
        check(lse_err <= 1e-4, f"flash f32 pair lse disagrees at {shape}: {lse_err}")
        check(all(torch.equal(a, bb) for a, bb in zip(fl.flash_mha_bwd(q, k_, v, o, lse, do, scale), grads)),
              "the flash f32 pair's backward is not deterministic")
        del grads
        fwd_ms, fwd_plain_ms = in_turns(lambda: fl.flash_mha_fwd(q, k_, v, scale),
                                        lambda: fl.flash_fwd_plain(q, k_, v, scale))
        bwd_ms, bwd_plain_ms = in_turns(lambda: fl.flash_mha_bwd(q, k_, v, o, lse, do, scale),
                                        lambda: fl.flash_bwd_plain(q, k_, v, o, lse, do, scale))
        backend = sdpa_backend(q, k_, v, scale)
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k_, v))
        with sdpa_kernel([backend]):
            lib_fwd_ms = alone(lambda: F.scaled_dot_product_attention(q, k_, v, scale=scale))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            lib_bwd_ms = alone(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True))
        work, el = b_ * h_ * nq * nk * d, q.element_size()
        io = el * b_ * h_ * (2 * nq + 2 * nk) * d
        fwd_bytes, bwd_bytes = io + 4.0 * b_ * h_ * nq, 2 * io + 4.0 * b_ * h_ * nq
        # 3xTF32: each float32 operation three TF32 tensor-core ones; the
        # CUDA-core float32 bound beside it
        fwd_bound = bound(fwd_bytes, 4.0 * work, "tf32x3")
        bwd_bound = bound(bwd_bytes, 10.0 * work, "tf32x3")
        fwd_f32, bwd_f32 = bound(fwd_bytes, 4.0 * work, "f32"), bound(bwd_bytes, 10.0 * work, "f32")
        n_use = uses.get(shape, 0) if dtype == torch.float32 else 0
        print(f"[kernel] flash f32 pair {shape} {dtype} x{n_use} blocks: fwd {fwd_ms} ms (plain {fwd_plain_ms}, "
              f"SDPA {lib_fwd_ms} by {backend.name}, 3xTF32 bound {fwd_bound[0]} {fwd_bound[1]}, "
              f"{fwd_bound[0] / fwd_ms} of it; CUDA-core float32 bound {fwd_f32[0]}); bwd {bwd_ms} ms "
              f"(plain {bwd_plain_ms}, SDPA {lib_bwd_ms}, 3xTF32 bound {bwd_bound[0]} {bwd_bound[1]}, "
              f"{bwd_bound[0] / bwd_ms} of it; CUDA-core float32 bound {bwd_f32[0]}); vs SDPA: fwd "
              f"{lib_fwd_ms / fwd_ms}x, bwd {lib_bwd_ms / bwd_ms}x")
        for key, vals in (("flash_f32_fwd", (fwd_ms, fwd_plain_ms, lib_fwd_ms, fwd_bound)),
                          ("flash_f32_bwd", (bwd_ms, bwd_plain_ms, lib_bwd_ms, bwd_bound))):
            tot = totals[key]
            tot["ms"] += n_use * vals[0]
            tot["plain_ms"] += n_use * vals[1]
            tot["library_ms"] += n_use * vals[2]
            tot["bound"][0] += n_use * vals[3][0]
            tot["bound"][1] += n_use * (1.0 if vals[3][1] == "operations" else 0.0)
        del q, k_, v, do, o, lse, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    for key, tot in totals.items():
        tot["bound"] = (tot["bound"][0], "operations" if tot["bound"][1] * 2 >= len(per_block) else "bytes")
        print(f"[kernel] {key} over the encoder's {len(per_block)} blocks in float32: {tot['ms']} ms, plain "
              f"{tot['plain_ms']} ms, SDPA {tot['library_ms']} ms, 3xTF32 bound {tot['bound'][0]} ms "
              f"({tot['bound'][1]}; {tot['bound'][0] / tot['ms']} of it), max_abs_err {tot['max_abs_err']}")
    return totals


def gather_alone(wp, x, y, arrays, sum0, u8, o):
    """The card's ms a launch of GATHER_LAUNCHES window_gather launches back
    to back through the C entry point (pointers and arrays made once),
    queued behind torch.cuda._sleep so that the card runs them only once the
    host has queued them all; median of 5 samples."""
    import torch

    lib, xp, yp = wp._library(), x.data_ptr(), y.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    check(lib.window_gather(xp, yp, *arrays, sum0, u8, o, o, stream) == 0, "window_gather failed")
    torch.cuda.synchronize()
    ms = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(GATHER_LAUNCHES):
            lib.window_gather(xp, yp, *arrays, sum0, u8, o, o, stream)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / GATHER_LAUNCHES)
    return statistics.median(ms)


def window_probes(wp, dev, in_turns, results):
    """The window kernel at each Mosaic probe's shape and offset, exactly
    equal to its plain version and timed beside it, and alone (back-to-back
    launches through its C entry point) beside the launch floor (the same at
    a one-element window); then the probe tool (tools/probe_windows.py), the
    probes' own path, with the counts set to 0 just before it. Returns the
    tool's launches."""
    import ctypes

    import torch
    from advise_tpu_torch.tools import probe_windows

    inputs = probe_windows.probe_inputs(dev)
    alone = {}
    for name, o in probe_windows.probe_offsets().items():
        win, x, entry = wp.WINDOWS[name], inputs[name], wp.ENTRIES[name]
        got = entry(o, x)
        want = wp.window_plain(win, x, (o, o))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"window probe {name} differs from its plain version")
        ms, plain_ms = in_turns(lambda: entry(o, x), lambda: wp.window_plain(win, x, (o, o)))
        reads = got.numel() * (win.out[0] if win.sum_axis0 else 1)
        b = bound(reads * x.element_size() + 4.0 * got.numel(),
                  float(reads - got.numel()), "f32")
        alone[name] = gather_alone(wp, x, got, wp._SPECS[name], int(win.sum_axis0),
                                   int(win.dtype == torch.uint8), o)
        print(f"[kernel] window {name} {tuple(x.shape)} {x.dtype} o={o} -> {tuple(got.shape)}: equal, "
              f"{ms} ms, plain {plain_ms} ms, bound {b[0]} ms ({b[1]})")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound=b)
    one = [(ctypes.c_int * wp.RANK)(*vals) for vals in
           ((1,) * 4, (1,) * 4, (0,) * 4, (-1,) * 4, (1,) * 4, (1,) * 4, (0,) * 4, (0,) * 4)]
    floor_ms = gather_alone(wp, torch.zeros((1, 1, 1, 1), device=dev), torch.empty(1, device=dev),
                            one, 0, 0, 0)
    print(f"[kernel] window_gather launch floor: {floor_ms} ms a launch at a one-element window "
          f"({GATHER_LAUNCHES} launches back to back through the C entry point, on the card's clock)")
    for name, ms in alone.items():
        b = max(results[name]["bound"][0], floor_ms)
        print(f"[kernel] window {name}: the kernel alone {ms} ms a launch (wrapper {results[name]['ms']} "
              f"ms), against max(byte bound, launch floor) {b} ms: {b / ms} of it")
    for entry in wp.ENTRIES.values():
        entry.launches = 0
    check(probe_windows.main() == 0, "the probe tool failed")
    launches = {name: entry.launches for name, entry in wp.ENTRIES.items()}
    print(f"[kernel] window probe launches by the probe tool: {launches}")
    check(all(n == 1 for n in launches.values()), "the probe tool did not launch each probe once")
    return launches


def run_entry_point(extra, label, config=BYOL_CONFIG, out_dir=RUN_DIR, overrides=RUN_OVERRIDES):
    """The entry point, ``advise_tpu_torch.tools.run.main`` (what ``python
    -m advise_tpu_torch.tools.run`` calls), on ``config`` into ``out_dir``
    with ``overrides`` and ``extra``, every launch count set to 0 first;
    returns its run record. It runs in this process, so that the imports,
    the CUDA context and the libraries' first-use loading are paid once
    for the script and not once a run; its log is captured, and the lines
    that matter are printed after it."""
    import contextlib
    import io
    import logging

    import torch

    from advise_tpu_torch.tools import run as entry

    argv = ["--cfg", config, "--output", out_dir] + overrides + extra
    print(f"[run] {label}: -m advise_tpu_torch.tools.run {' '.join(argv)}")
    for fn in entry.counted_wrappers():
        fn.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[run]   the script holds {torch.cuda.memory_allocated()} bytes on the card as the run starts "
          "(inside the run's peak)")
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            record = entry.main(argv)
    except BaseException:
        print(log.getvalue()[-4000:])
        raise
    finally:
        root = logging.getLogger()  # the run's handlers: its stdout and its log.txt
        for handler in list(root.handlers):
            root.removeHandler(handler)
            handler.close()
    seconds = time.perf_counter() - t0
    for line in log.getvalue().splitlines():
        if any(key in line for key in ("device:", "start:", "Epoch", "kNN", "saved", "best",
                                       "resuming", "mirror", "profiler trace stopped")):
            print(f"[run]   {line}")
    check(isinstance(record, dict) and "launches" in record, f"the entry point returned no run record ({label})")
    check(record["launches"]["channels_last"] == 0, f"{label}: a BN input or gradient was copied to channels-last")
    record["seconds"] = seconds
    gc.collect()
    torch.cuda.empty_cache()
    return record


BN_KERNELS = ("bn_stats", "bn_apply", "bn_grad_stats", "bn_dx")  # SyncBatchNorm's kernel wrappers


def but_bn(launches: dict) -> dict:
    """A run record's launch counts without SyncBatchNorm's kernels (they
    run in every model that has a BN), its layout copies kept: what a
    path's check that it reaches no other kernel and copies nothing reads."""
    return {name: n for name, n in launches.items() if name not in BN_KERNELS}


def run_models(run) -> list:
    """The modules a step of ``run`` (``compare_steps.step_run``) calls: its
    model and those its SSL state holds (a momentum encoder)."""
    import torch

    return [run.state.model] + [v for v in (run.state.ssl or {}).values() if isinstance(v, torch.nn.Module)]


@contextlib.contextmanager
def bn_on_kernels(label, steps, *models):
    """Inside the block, every train-mode call of a SyncBatchNorm of
    ``models`` is recorded in ``calls`` as (shape, dtype, splits,
    recomputed inside a backward), and each whose output's gradient the
    backward reached in ``backwards`` as (shape, dtype, splits, x needs a
    gradient); after it, the BN kernels' launches must be once a call each
    (the statistics and the fold), once a backward (the sums) and once a
    backward whose input needs a gradient (dx), with no layout copy. Yields
    the record."""
    from types import SimpleNamespace

    from advise_tpu_torch.models.layers.norm import SyncBatchNorm, _in_backward
    from advise_tpu_torch.ops import batch_norm as bn

    seen = SimpleNamespace(calls=[], backwards=[])

    def hook(m, args, kwargs, y):
        if m.training:
            x = args[0]
            views = args[1] if len(args) > 1 else kwargs.get("views", 1)
            key = (tuple(x.shape), x.dtype, views * m.num_splits)
            seen.calls.append(key + (_in_backward(),))
            if y.requires_grad and not _in_backward():
                y.register_hook(lambda g, rec=key + (x.requires_grad,): seen.backwards.append(rec))

    norms = {id(m): m for model in models for m in model.modules() if isinstance(m, SyncBatchNorm)}
    handles = [m.register_forward_hook(hook, with_kwargs=True) for m in norms.values()]
    before = {fn.__name__: fn.launches for fn in bn.COUNTED}
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()
    got = {fn.__name__: fn.launches - before[fn.__name__] for fn in bn.COUNTED}
    n = len(seen.calls)
    want = {"bn_stats": n, "bn_apply": n, "bn_grad_stats": len(seen.backwards),
            "bn_dx": sum(c[3] for c in seen.backwards), "channels_last": 0}
    print(f"[bn] {label}: a step {n / steps} train-mode BN calls of {len(norms)} BNs "
          f"({sum(c[3] for c in seen.calls) / steps} recomputed inside the backward, {len(seen.backwards) / steps} "
          f"backwards), kernel launches a step {({k: v / steps for k, v in got.items()})}, layout copies a step "
          f"{got['channels_last'] / steps}")
    check(got == want, f"{label}: SyncBatchNorm's kernels ran {got}, not once a call ({want})")


def bn_kernel_rows(seen, steps, dev, results) -> None:
    """SyncBatchNorm's kernels at each distinct train-mode BN shape of
    ``seen`` (:func:`bn_on_kernels`' record of ``steps`` steps), channels-last,
    on x ~ N(1, 2^2), g ~ N(0, 1) and a random scale and bias: each wrapper
    held against its plain version on the card on the same inputs (the
    tolerances of the card tests: the statistics within 1e-5, meansq
    relative to itself and the mean to the root of meansq; y within one ulp
    of x's type at its largest value; the backward's means and sums and dx
    within 2^-7 of their largest entry); then the forward (statistics +
    fold) and the backward (sums + dx) on the card's clock (calls queued
    behind a sleep) beside their plain versions and their byte bounds (3
    and 5 passes over x), summed over a step's calls into
    ``results["bn_forward"]`` and ``results["bn_backward"]``."""
    import torch

    from advise_tpu_torch.ops import batch_norm as bn

    eps = 1e-5
    forwards = Counter(c[:3] for c in seen.calls)
    backwards = Counter(c[:3] for c in seen.backwards)
    fwd = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, bound=(0.0, "bytes"))
    bwd = dict(fwd)
    g = torch.Generator(device=dev).manual_seed(23)
    for (shape, dtype, splits), n_fwd in sorted(forwards.items(), key=lambda kv: -math.prod(kv[0][0])):
        n_fwd, n_bwd = n_fwd / steps, backwards[(shape, dtype, splits)] / steps

        def draw(scale, shift):
            t = torch.randn(shape, generator=g, device=dev) * scale + shift
            return (t.movedim(1, -1).contiguous().movedim(-1, 1) if len(shape) > 2 else t).to(dtype)

        x, gy = draw(2.0, 1.0), draw(1.0, 0.0)
        c = shape[1]
        weight, bias = torch.randn(c, generator=g, device=dev), torch.randn(c, generator=g, device=dev)
        stats, stats_p = bn.bn_stats(x, splits), bn.bn_stats_plain(x, splits)
        stats_err = max(float(((stats[1] - stats_p[1]).abs() / stats_p[1]).max()),
                        float(((stats[0] - stats_p[0]).abs() / stats_p[1].sqrt()).max()))
        y, y_p = bn.bn_apply(x, stats, weight, bias, eps), bn.bn_apply_plain(x, stats, weight, bias, eps)
        y_err = float((y.float() - y_p.float()).abs().max())
        top = float(y_p.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - (7 if dtype == torch.bfloat16 else 23))
        (means, totals), (means_p, totals_p) = (bn.bn_grad_stats(gy, x, stats, eps),
                                                bn.bn_grad_stats_plain(gy, x, stats, eps))
        sums_err = max(float((a - b).abs().max()) / float(b.abs().max())
                       for a, b in ((means, means_p), (totals, totals_p)))
        dx, dx_p = (bn.bn_dx(gy, x, stats, means, weight, eps),
                    bn.bn_dx_plain(gy, x, stats, means, weight, eps))
        dx_err = float((dx.float() - dx_p.float()).abs().max())
        dx_top = float(dx_p.float().abs().max())
        del y, y_p, dx, dx_p
        check(stats_err <= 1e-5 and y_err <= ulp and sums_err <= 2 ** -7 and dx_err <= 2 ** -7 * dx_top,
              f"BN kernels at {shape} {dtype} off their plain versions: statistics {stats_err}, y {y_err} "
              f"(ulp {ulp}), sums {sums_err}, dx {dx_err} of {dx_top}")
        nbytes = x.numel() * x.element_size()
        t = {
            "fwd": queued_ms(lambda: bn.bn_apply(x, bn.bn_stats(x, splits), weight, bias, eps), BN_REPS),
            "fwd_plain": times_ms(lambda: bn.bn_apply_plain(x, bn.bn_stats_plain(x, splits), weight, bias, eps)),
            "bwd": queued_ms(lambda: (bn.bn_grad_stats(gy, x, stats, eps),
                                      bn.bn_dx(gy, x, stats, means, weight, eps)), BN_REPS),
            "bwd_plain": times_ms(lambda: (bn.bn_grad_stats_plain(gy, x, stats, eps),
                                           bn.bn_dx_plain(gy, x, stats, means, weight, eps))),
        }
        t = {k: statistics.median(v) for k, v in t.items()}
        fb, bb = bound(3 * nbytes, 0, "bf16")[0], bound(5 * nbytes, 0, "bf16")[0]
        p = bn.plan(x.numel() // c, c, splits, dtype, bn.VECTOR_BYTES)
        print(f"[kernel] BN {shape} {str(dtype).split('.')[-1]} splits {splits}, {n_fwd} forwards and {n_bwd} "
              f"backwards a step; plan vec {p['vec']} threads {p['threads']} grid {p['grid']}: forward "
              f"{t['fwd']} ms (bound {fb}, plain {t['fwd_plain']}), backward {t['bwd']} ms (bound {bb}, plain "
              f"{t['bwd_plain']}); errors: statistics {stats_err}, y {y_err} (ulp {ulp}), sums {sums_err}, dx "
              f"{dx_err} of {dx_top}")
        for row, n, key, b_ms, err in ((fwd, n_fwd, "fwd", fb, y_err), (bwd, n_bwd, "bwd", bb, dx_err)):
            row["ms"] += n * t[key]
            row["plain_ms"] += n * t[key + "_plain"]
            row["bound"] = (row["bound"][0] + n * b_ms, "bytes")
            row["max_abs_err"] = max(row["max_abs_err"], err)
        del x, gy
        torch.cuda.empty_cache()
    for name, row in (("bn_forward", fwd), ("bn_backward", bwd)):
        print(f"[kernel] {name} over a step's calls: {row['ms']} ms, plain {row['plain_ms']} ms, bound "
              f"{row['bound'][0]} ms ({row['bound'][0] / row['ms']} of it), max_abs_err {row['max_abs_err']}")
        results[name] = row


def times_ms(fn, n=10, reps=1):
    """Each sample: ``reps`` calls back to back between two CUDA events, per
    call; ``n`` samples."""
    import torch

    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def queued_ms(fn, reps):
    """The card's time a call: 10 samples of ``reps`` calls queued behind
    torch.cuda._sleep, so that the card starts them only once the host has
    queued them all."""
    import torch

    out = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def counted_kernels():
    """Every kernel wrapper that counts its launches."""
    from advise_tpu_torch.ops import flash_attention as fl
    from advise_tpu_torch.ops import fused_aug as fa
    from advise_tpu_torch.ops import stem_conv as sc

    return (sc.stem_conv_fwd, sc.stem_conv_wgrad, fa.fused_simple_aug, fl.flash_mha_fwd,
            fl.flash_mha_bwd, fl.flash_f32_fwd, fl.flash_f32_bwd)


def eval_forward(tconfig, dev) -> None:
    """Phase 4's eval check: the eval step (``make_eval_step``: the
    inference crop, the cast, the eval-mode forward) of the linear probe's
    Slow-R50 (101 classes, a linear head) on EVAL_SMALL_CLIPS uint8 clips of
    8 x 256 x 341, bf16 on the card against float32 on the CPU with the same
    weights and crops."""
    import numpy as np
    import torch

    from advise_tpu_torch.data import build_device_aug, ingest_geometry
    from advise_tpu_torch.engine.steps import make_eval_step
    from advise_tpu_torch.models import build_model

    pcfg = one_card_cfg(tconfig, PROBE_CONFIG)
    ref_cfg = pcfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    w, h = ingest_geometry(pcfg, "action")
    clips = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (EVAL_SMALL_CLIPS, 1, pcfg.INFER.NUM_FRAMES, h, w, 3), dtype=np.uint8))
    aug = build_device_aug(pcfg, "action")
    crops = aug.sample(EVAL_SMALL_CLIPS, pcfg.INFER.NUM_FRAMES, h, w, 3, torch.Generator().manual_seed(0))
    want = make_eval_step(ref_cfg, lambda x, g: aug.apply(x, crops))(
        build_model(ref_cfg, "cpu", seed=0), clips, None)
    got = make_eval_step(pcfg, lambda x, g: aug.apply(x, crops))(build_model(pcfg, dev, seed=0), clips.to(dev), None)
    check(tuple(got.shape) == (EVAL_SMALL_CLIPS, 1, pcfg.MODEL.NUM_CLASSES), f"eval logits {tuple(got.shape)}")
    rel = float((got.float().cpu() - want).abs().max() / want.abs().max())
    # bf16 activations through ~50 layers, as the other phase-4 forwards
    print(f"[small] Slow-R50 probe eval step {tuple(got.shape)} (crop {pcfg.INFER.RES}, bf16 on the card): "
          f"max rel err vs CPU float32 {rel} (bound 5e-2)")
    check(math.isfinite(rel) and rel <= 5e-2, "the card's eval step disagrees with the CPU")


def advise_forward(tconfig, dev, label="ViT-B/16 + R3D", overrides=None) -> None:
    """Phase 4's AdViSe check: the full-width model (ViT-B/16 tower, the R3D
    head or the head ``overrides`` set) on the card in bf16 against the same
    weights' float32 forward on the CPU, eval mode, ADVISE_SMALL_CLIPS clips
    of 8 frames."""
    import numpy as np
    import torch

    from advise_tpu_torch.models import build_model

    acfg = one_card_cfg(tconfig, ADVISE_CONFIG, overrides)
    ref_cfg = acfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    ref_cfg.TM.ENABLE_BF16 = False
    ref = build_model(ref_cfg, "cpu", seed=0).eval()
    card = build_model(acfg, dev, seed=0).eval()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (ADVISE_SMALL_CLIPS, acfg.DATA.NUM_FRAMES, 224, 224, 3)).astype(np.float32))
    with torch.no_grad():
        want_feat = ref.features(x)
        want = ref.classify(want_feat)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got_feat = card.features(x.to(dev).bfloat16())
            got = card.classify(got_feat)
    for out_name, a, r in (("features", got_feat, want_feat), ("logits", got, want)):
        check(tuple(a.shape) == tuple(r.shape), f"AdViSe {out_name} has shape {tuple(a.shape)}")
        rel = float((a.float().cpu() - r).abs().max() / r.abs().max())
        # bf16 through the 12-layer tower and the 4-block head: ~1e-2
        print(f"[small] AdViSe {label} {out_name} {tuple(a.shape)}: max rel err vs CPU float32 "
              f"{rel} (bound 5e-2)")
        check(math.isfinite(rel) and rel <= 5e-2, f"the card's AdViSe {label} {out_name} disagrees with the CPU")
    del ref, card
    torch.cuda.empty_cache()


def swin_forward(tconfig, dev) -> None:
    """Phase 4's Swin check: Swin-B MoCo (ContrastiveModel, the 128-d MLP
    projection) built for SWIN_SMALL_SIZE^2, on SWIN_SMALL_CLIPS clip of 16
    frames: bf16 on the card against the same weights' float32 forward on
    the CPU, eval mode."""
    import numpy as np
    import torch

    from advise_tpu_torch.models import build_model

    cfg = one_card_cfg(tconfig, SWIN_CONFIG, {"AUG.TARGET_SIZE": SWIN_SMALL_SIZE})
    ref_cfg = cfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (SWIN_SMALL_CLIPS, cfg.DATA.NUM_FRAMES, SWIN_SMALL_SIZE, SWIN_SMALL_SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        want = build_model(ref_cfg, "cpu", seed=0).eval()(x)
        card = build_model(cfg, dev, seed=0).eval()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = card(x.to(dev).bfloat16())
    check(tuple(got.shape) == (SWIN_SMALL_CLIPS, cfg.CONTRASTIVE.DIM), f"Swin-B output {tuple(got.shape)}")
    rel = float((got.float().cpu() - want).abs().max() / want.abs().max())
    # bf16 activations through 24 blocks, as the other phase-4 forwards
    print(f"[small] Swin-B MoCo {tuple(x.shape)} -> {tuple(got.shape)} (bf16 on the card; stage 4 pads 7 -> 8 "
          f"and clamps its window to (8, 4, 4)): max rel err vs CPU float32 {rel} (bound 5e-2)")
    check(math.isfinite(rel) and rel <= 5e-2, "the card's Swin-B forward disagrees with the CPU")
    del card
    torch.cuda.empty_cache()


def small_forwards(tconfig, dev) -> None:
    """Phase 4's X3D and MoCo checks: X3D-M at the preset's width (4
    classes) on SMALL_CLIPS clips of 16 frames, and the MoCo Slow-R18 of
    moco_knn_minik400.yaml on SMALL_CLIPS clips of 8 frames, both at
    SMALL_SIZE^2: bf16 on the card against the same weights' float32
    forward on the CPU, eval mode."""
    import numpy as np
    import torch

    from advise_tpu_torch.models import build_model

    for label, path in (("X3D-M", X3D_CONFIG), ("MoCo Slow-R18", MOCO_CONFIG)):
        cfg = one_card_cfg(tconfig, path)
        ref_cfg = cfg.clone()
        ref_cfg.TPU.COMPUTE_DTYPE = "float32"
        x = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (SMALL_CLIPS, cfg.DATA.NUM_FRAMES, SMALL_SIZE, SMALL_SIZE, 3)).astype(np.float32))
        with torch.no_grad():
            want = build_model(ref_cfg, "cpu", seed=0).eval()(x)
            card = build_model(cfg, dev, seed=0).eval()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                got = card(x.to(dev).bfloat16())
        check(tuple(got.shape) == tuple(want.shape), f"{label} output {tuple(got.shape)}")
        rel = float((got.float().cpu() - want).abs().max() / want.abs().max())
        # bf16 activations through the whole network, as the other phase-4 forwards
        print(f"[small] {label} {tuple(x.shape)} -> {tuple(got.shape)} (bf16 on the card): max rel err vs "
              f"CPU float32 {rel} (bound 5e-2)")
        check(math.isfinite(rel) and rel <= 5e-2, f"the card's {label} forward disagrees with the CPU")
        del card
    torch.cuda.empty_cache()


def conv_layers(model, x):
    """Every Conv3d that one eval-mode forward of ``model`` on ``x`` runs:
    (the forward's FLOPs, multiply-adds x 2, of the channelwise convs
    (groups == channels) and of the others, {'depthwise': flops, 'other':
    flops}; the channelwise layers {(input shape, weight shape, stride,
    padding, dilation): count}, batch as ``x`` gives it)."""
    import torch

    flops, channelwise = {"depthwise": 0, "other": 0}, {}

    def hook(mod, inputs, output):
        dw = mod.groups > 1 and mod.groups == mod.in_channels
        # in channels per group x kernel volume, a multiply-add each
        flops["depthwise" if dw else "other"] += 2 * output.numel() * mod.weight[0].numel()
        if dw:
            key = (tuple(inputs[0].shape), tuple(mod.weight.shape), mod.stride, mod.padding, mod.dilation)
            channelwise[key] = channelwise.get(key, 0) + 1

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, torch.nn.Conv3d)]
    was_training = model.training
    model.eval()  # a train-mode forward would record BN statistics
    with torch.no_grad(), torch.autocast(x.device.type, dtype=torch.bfloat16):
        model(x)
    model.train(was_training)
    for h in handles:
        h.remove()
    return flops, channelwise


def time_channelwise(layers, batch, fwd_passes, dev, reps=3):
    """Each channelwise conv of ``layers`` (:func:`conv_layers`) alone
    at ``batch`` clips in bf16, forward and backward (input and weight
    gradients), channels-last (the model's layout) and NCDHW: CUDA-event
    medians of ``reps``. Prints a line a layer; returns the estimate of the
    step's channelwise time (``fwd_passes`` forwards and one backward of
    each layer, channels-last), the same in NCDHW, and the names of the
    kernels these convolutions launch."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from advise_tpu_torch.engine.meters import device_events

    def timed(fn):
        out = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out)

    g = torch.Generator(device=dev).manual_seed(0)
    totals = {"channels_last": 0.0, "ncdhw": 0.0}
    names = set()
    for (shape, wshape, stride, pad, dil), count in sorted(layers.items()):
        row = {}
        for layout in totals:
            fmt = torch.channels_last_3d if layout == "channels_last" else torch.contiguous_format
            x = torch.randn((batch,) + shape[1:], device=dev, generator=g).bfloat16()
            x = x.contiguous(memory_format=fmt).requires_grad_(True)
            w = (torch.randn(wshape, device=dev, generator=g) * 0.1).bfloat16()
            w = w.contiguous(memory_format=fmt).requires_grad_(True)

            def fwd():
                return F.conv3d(x, w, None, stride, pad, dil, wshape[0])

            y = fwd()
            gy = torch.randn_like(y).contiguous(memory_format=fmt)

            def bwd():
                torch.autograd.grad(fwd(), (x, w), gy)

            fwd_ms = timed(fwd)
            fb_ms = timed(bwd)
            row[layout] = (fwd_ms, fb_ms - fwd_ms)
            totals[layout] += count * (fwd_passes * fwd_ms + (fb_ms - fwd_ms))
            if layout == "channels_last":
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    bwd()
                    torch.cuda.synchronize()
                names |= {name for name, _, _ in device_events(prof)}
            del x, w, y, gy
        flops = 2 * batch * math.prod(shape[1:]) // (stride[1] * stride[2]) * math.prod(wshape[2:])
        print(f"[x3d]   channelwise conv {(batch,) + shape[1:]} weight {wshape} stride {stride} x{count}: "
              f"channels-last fwd {row['channels_last'][0]} ms, bwd {row['channels_last'][1]} ms; NCDHW fwd "
              f"{row['ncdhw'][0]} ms, bwd {row['ncdhw'][1]} ms ({flops / 1e9} GFLOP a forward)")
    torch.cuda.empty_cache()
    return totals["channels_last"], totals["ncdhw"], names


def profile_step(label, run_step, tag, kernel_names=frozenset()):
    """One call of ``run_step`` under torch.profiler: the device kernels by
    summed time, the device's busy and idle share of the wall time, and the
    share of the summed time of the kernels named in ``kernel_names`` (the
    channelwise conv3d's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from advise_tpu_torch.engine.meters import busy_ms, device_events

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_events(prof)
    busy = busy_ms((start, end) for _, start, end in kernels)
    by_name = {}
    for name, start, end in kernels:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    total = sum(by_name.values())
    dw = {n: ms for n, ms in by_name.items() if n in kernel_names}
    dw_text = (f"; kernels of the names the channelwise convolutions launch alone {sum(dw.values())} ms "
               f"({sum(dw.values()) / max(total, 1e-9)} of the summed time)") if kernel_names else ""
    print(f"[{tag}] {label} profiled step: wall {wall} ms, device busy {busy} ms, idle share "
          f"{1.0 - busy / wall}, {len(kernels)} kernels, summed kernel time {total} ms (kernels overlap: "
          f"the sum exceeds the busy time){dw_text}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"[{tag}]   {ms:.3f} ms  {name[:150]}")
    for name, ms in sorted(dw.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   channelwise kind: {ms:.3f} ms  {name[:150]}")
    return {"wall_ms": wall, "busy_ms": busy, "summed_ms": total, "depthwise_ms": sum(dw.values())}


def x3d_steps(xcfg, label, warmup, timed, dev, profiled=False):
    """The X3D speed step of ``xcfg`` (``step_run``: uint8 clips [B, K, T,
    256, 320, 3] through the simple aug, the lr from the port's policy),
    warmup + timed steps (``time_steps``); prints each step, the median,
    clips/s, the peak memory, the parameter count and the conv arithmetic
    rate; with ``profiled`` one more step under torch.profiler. Returns
    (median ms, peak bytes, launches by kernel)."""
    import torch

    from advise_tpu_torch.tools.compare_steps import step_run, time_steps

    run = step_run(xcfg, dev, 5, X3D_EPOCH)
    model = run.state.model
    n_params = sum(p.numel() for p in model.parameters())
    b, k, t = xcfg.DATA.BATCHSIZE_PER_GPU, xcfg.DATA.NUM_CLIP, xcfg.DATA.NUM_FRAMES
    size = int(xcfg.AUG.TARGET_SIZE)
    # the step's convolution arithmetic: a forward, its recompute under
    # REMAT, and a backward of two convolutions per forward one
    fwd, layers = conv_layers(model, torch.zeros((1, t, size, size, 3), device=dev, dtype=torch.bfloat16))
    passes = 4 if xcfg.TPU.REMAT else 3
    step_flops = {kind: v * b * k * passes for kind, v in fwd.items()}
    print(f"[x3d] {label}: {n_params} params, clips {tuple(run.clips.shape)} uint8 -> crop {size}, "
          f"{xcfg.TPU.COMPUTE_DTYPE}, REMAT {xcfg.TPU.REMAT}, PALLAS_AUG {xcfg.TPU.PALLAS_AUG}, "
          f"{xcfg.SOLVER.OPTIMIZING_METHOD}, lr {run.lr} at epoch {X3D_EPOCH}; conv arithmetic a step "
          f"{step_flops['depthwise'] / 1e12} TFLOP channelwise + {step_flops['other'] / 1e12} TFLOP other")

    def after_step(i, vals, ms):
        print(f"[x3d] {label} step {i}: {vals} ({ms} ms)")
        check(all(math.isfinite(v) for v in vals.values()), f"X3D {label} step {i} is not finite")

    with bn_on_kernels(f"X3D {label}", warmup + timed, *run_models(run)):
        median_ms, step_ms, peak, launches = time_steps(run, warmup, timed, counted_kernels(),
                                                        after_step=after_step)
    check(run.state.step == warmup + timed, f"the X3D {label} state did not advance")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), f"X3D {label} params not finite")
    total = sum(step_flops.values())
    print(f"[x3d] {label}: median step {median_ms} ms over {timed} steps (all: {step_ms}), "
          f"{b * k * 1e3 / median_ms} clips/s ({b} videos x {k} clips x {t} frames), peak allocated {peak} "
          f"bytes, conv rate {total / median_ms / 1e9} TFLOP/s, launches {launches}")
    if profiled:
        # the channelwise convolutions alone at the step's shapes, then the
        # step under the profiler
        dw_ms, dw_ncdhw_ms, names = time_channelwise(layers, b * k, passes - 2, dev)
        print(f"[x3d] {label}: {sum(layers.values())} channelwise convolutions in {len(layers)} shapes; alone "
              f"they take {dw_ms} ms a step channels-last ({dw_ms / median_ms} of the step, "
              f"{step_flops['depthwise'] / dw_ms / 1e9} TFLOP/s), {dw_ncdhw_ms} ms in NCDHW; the rest of the "
              f"step {median_ms - dw_ms} ms for {step_flops['other'] / 1e12} TFLOP of other convolutions "
              f"({step_flops['other'] / max(median_ms - dw_ms, 1e-9) / 1e9} TFLOP/s)")
        profile_step(label, run.call, "x3d", frozenset(names))
    del run, model
    gc.collect()  # run.call holds the run
    torch.cuda.empty_cache()
    return median_ms, peak, launches


def moco_steps(mcfg, epoch, warmup, timed, extra, dev, tag="moco", profiled=False):
    """The MoCo contrastive step of ``mcfg`` (``step_run``: rbyol aug,
    shuffle-BN, the queue) on one card, warmup + timed steps and ``extra``
    more that run the queue's pointer round (``time_steps``); with
    ``profiled`` one more step under torch.profiler; then the kNN probe on
    one batch (with CONTRASTIVE.KNN_BATCH_STATS on batch statistics), which
    must leave every running statistic bit for bit as it was. Returns
    (median ms, peak bytes, launches by kernel, the profile or None)."""
    import torch

    from advise_tpu_torch.engine.checkpoint import tensors_digest
    from advise_tpu_torch.engine.contrastive import momentum_at
    from advise_tpu_torch.engine.steps import make_knn_probe_step
    from advise_tpu_torch.tools.compare_steps import step_run, time_steps

    run = step_run(mcfg, dev, 6, epoch)
    state, model = run.state, run.state.model
    b, k, t = mcfg.DATA.BATCHSIZE_PER_GPU, mcfg.DATA.NUM_CLIP, mcfg.DATA.NUM_FRAMES
    queue_len = mcfg.CONTRASTIVE.QUEUE_LEN
    n_params = sum(p.numel() for p in model.parameters())
    bank = state.ssl["knn_mem"]
    print(f"[{tag}] {n_params} params, clips {tuple(run.clips.shape)} uint8 -> rbyol crop {mcfg.AUG.TARGET_SIZE}, "
          f"{mcfg.TPU.COMPUTE_DTYPE}, REMAT {mcfg.TPU.REMAT}, {mcfg.SOLVER.OPTIMIZING_METHOD} (LARS "
          f"{mcfg.SOLVER.LARS_ON}), queue {queue_len} x {mcfg.CONTRASTIVE.DIM}, kNN bank {tuple(bank.shape)} "
          f"{bank.dtype} on {bank.device} ({bank.numel() * bank.element_size()} bytes), lr {run.lr} and momentum "
          f"{momentum_at(mcfg, epoch)} (annealing {mcfg.CONTRASTIVE.MOMENTUM_ANNEALING}) at epoch {epoch}")
    check(bank.is_cuda and bank.shape[0] == mcfg.CONTRASTIVE.LENGTH, f"{tag}: the kNN bank is not on the card")
    ptrs, accs = [], []

    def after_step(i, vals, ms):
        ptrs.append(int(state.ssl["ptr"]))
        accs.append(vals["acc_ins"])
        if i < warmup + timed:
            print(f"[{tag}] step {i}: {vals} ptr {ptrs[-1]} ({ms} ms)")
        check(all(math.isfinite(v) for v in vals.values()), f"{tag} step {i} is not finite")

    with bn_on_kernels(tag, warmup + timed + extra, *run_models(run)):
        _, step_ms, peak, launches = time_steps(
            run, warmup, timed + extra, counted_kernels(),
            infos_fn=lambda i: {"item_id": torch.arange(b, device=dev) + (i * b) % mcfg.CONTRASTIVE.LENGTH},
            after_step=after_step)
    median_ms = statistics.median(step_ms[warmup:warmup + timed])
    want_ptrs = [(b * (i + 1)) % queue_len for i in range(len(ptrs))]
    print(f"[{tag}] median step {median_ms} ms over {timed} steps (all: {step_ms[:warmup + timed]}), "
          f"{b * k * 1e3 / median_ms} clip-views/s ({b} videos x {k} clips x {t} frames), peak allocated "
          f"{peak} bytes, acc_ins {accs}, pointer {ptrs} (expected {want_ptrs}), launches {launches}")
    check(ptrs == want_ptrs and (extra == 0 or 0 in ptrs),
          f"the {tag} queue's pointer did not advance (and wrap) as expected")
    prof = profile_step(f"{tag} step", run.call, tag) if profiled else None
    # the kNN probe: the running statistics stay as they were
    state.ssl["knn_labels"] = torch.arange(mcfg.CONTRASTIVE.LENGTH, device=dev) % mcfg.MODEL.NUM_CLASSES
    probe = make_knn_probe_step(mcfg, run.aug, num_classes=mcfg.MODEL.NUM_CLASSES)
    before = tensors_digest(model.state_dict())
    acc = float(probe(state, run.clips, {"cls_id": torch.arange(b, device=dev) % mcfg.MODEL.NUM_CLASSES},
                      run.gen))
    unchanged = tensors_digest(model.state_dict()) == before
    pending = sum(len(getattr(m, "pending", [])) for m in model.modules())
    print(f"[{tag}] kNN probe with KNN_BATCH_STATS {mcfg.CONTRASTIVE.KNN_BATCH_STATS}: acc {acc}, model "
          f"unchanged {unchanged}, BN records left {pending}")
    check(unchanged and pending == 0 and math.isfinite(acc), f"the {tag} kNN probe moved the model or left BN records")
    del run, state, model
    gc.collect()
    torch.cuda.empty_cache()
    return median_ms, peak, launches, prof


def swin_attention_alone(scfg, dev, reps=5):
    """The window attention's float32 chain alone (``swin3d.window_softmax``:
    the scores of q * scale and k in float32, the bias, the shift mask, the
    softmax, the cast to bf16) at every block shape of ``scfg``'s Swin, on
    CUDA events: per block a forward for the key clips and a forward and
    backward for the query clips, as the MoCo step runs them. Returns (ms a
    step, unique shapes)."""
    import torch

    from advise_tpu_torch.models.swin3d import device_mask, get_window_size, merged_size, window_softmax

    sw = scfg.SWIN
    b, t, size = scfg.DATA.BATCHSIZE_PER_GPU, scfg.DATA.NUM_FRAMES, scfg.AUG.TARGET_SIZE
    grid = (t // sw.PATCH_SIZE[0], size // sw.PATCH_SIZE[1], size // sw.PATCH_SIZE[2])
    dim = sw.EMBED_DIM
    counts = {}
    for depth, heads in zip(sw.DEPTHS, sw.NUM_HEADS):
        for i in range(depth):
            shift_cfg = (0, 0, 0) if i % 2 == 0 else tuple(w // 2 for w in sw.WINDOW_SIZE)
            window, shift = get_window_size(grid, tuple(sw.WINDOW_SIZE), shift_cfg)
            padded = tuple(-(-g // w) * w for g, w in zip(grid, window))
            key = (padded, window, shift if any(shift) else None, heads, dim // heads)
            counts[key] = counts.get(key, 0) + 1
        grid, dim = merged_size(grid), dim * 2

    def timed(fn):
        fn()
        ms = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        return statistics.median(ms)

    total = 0.0
    gen = torch.Generator(device=dev).manual_seed(9)
    for (padded, window, shift, heads, hd), count in counts.items():
        n = math.prod(window)
        nw = math.prod(p // w for p, w in zip(padded, window))
        q = torch.randn((b * nw, heads, n, hd), generator=gen, device=dev).bfloat16().requires_grad_()
        k = torch.randn((b * nw, heads, n, hd), generator=gen, device=dev).bfloat16().requires_grad_()
        bias = (torch.randn((heads, n, n), generator=gen, device=dev) * 0.02).requires_grad_()
        mask = device_mask(*padded, window, shift, torch.device(dev)) if shift else None

        def chain():
            return window_softmax(q, k, bias, mask, hd ** -0.5, torch.bfloat16)

        with torch.no_grad():
            fwd = timed(chain)
        gout = torch.ones((b * nw, heads, n, n), device=dev, dtype=torch.bfloat16)
        both = timed(lambda: torch.autograd.grad(chain(), (q, k, bias), gout))
        total += count * (fwd + both)
        print(f"[swin] attention chain alone, {count} blocks at [{b * nw}, {heads}, {n}, {n}] (head dim {hd}, "
              f"shift mask {shift is not None}): forward {fwd} ms, forward + backward {both} ms")
        del q, k, bias, gout
    torch.cuda.empty_cache()
    return total, len(counts)


def swin_path(tconfig, dev) -> None:
    """Phase 7e: Swin-B's parameter count against the JAX package's, the
    SwinB_moco_32chips.yaml MoCo step at one card (moco_steps, profiled),
    and the share of the step its window attention's float32 chain takes
    alone."""
    import torch

    from advise_tpu_torch.models.contrastive import ContrastiveModel
    from advise_tpu_torch.models.layers.norm import get_norm

    scfg = one_card_cfg(tconfig, SWIN_CONFIG)
    with torch.device("meta"):
        n_swin = sum(p.numel() for p in ContrastiveModel(scfg, get_norm(scfg)).parameters())
    print(f"[swin] Swin-B MoCo: {n_swin} params (the JAX package's count {SWIN_B_PARAMS})")
    check(n_swin == SWIN_B_PARAMS, "Swin-B's parameter count differs from the JAX package's")
    median_ms, _, launches, prof = moco_steps(scfg, SWIN_EPOCH, WARMUP_STEPS, TIMED_STEPS, 0, dev, tag="swin",
                                             profiled=True)
    check(not any(launches.values()), "the Swin step launched a kernel: its path has none")
    chain_ms, shapes = swin_attention_alone(scfg, dev)
    print(f"[swin] the window attention's float32 chain alone: {chain_ms} ms a step over {shapes} shapes, "
          f"{chain_ms / median_ms} of the {median_ms} ms step ({chain_ms / prof['busy_ms']} of the profiled "
          f"step's device busy time)")


def x3d_path(tconfig, dev) -> None:
    """Phase 7c: X3D-M's parameter count, the X3D_M_K400.yaml speed step
    (x3d_steps, profiled), then its TPU.PALLAS_AUG variant, K3 once a step."""
    import torch

    from advise_tpu_torch.models.layers.norm import get_norm
    from advise_tpu_torch.models.x3d import X3D

    xcfg = one_card_cfg(tconfig, X3D_CONFIG)
    ref_cfg = xcfg.clone()
    ref_cfg.MODEL.NUM_CLASSES = 400
    with torch.device("meta"):
        n_x3d_m = sum(p.numel() for p in X3D(ref_cfg, get_norm(ref_cfg)).parameters())
    print(f"[x3d] X3D-M at 400 classes: {n_x3d_m} params (the JAX package's count {X3D_M_PARAMS})")
    check(n_x3d_m == X3D_M_PARAMS, "X3D-M's parameter count differs from the JAX package's")
    _, _, x3d_launches = x3d_steps(xcfg, "X3D_M_K400.yaml", WARMUP_STEPS, TIMED_STEPS, dev, profiled=True)
    check(not any(x3d_launches.values()), "the X3D step launched a kernel: its path has none")
    vcfg = xcfg.clone()
    vcfg.TPU.PALLAS_AUG = True
    _, _, v_launches = x3d_steps(vcfg, "PALLAS_AUG", VARIANT_WARMUP, VARIANT_TIMED, dev)
    print(f"[x3d] PALLAS_AUG: fused_simple_aug launches {v_launches['fused_simple_aug']} in "
          f"{VARIANT_WARMUP + VARIANT_TIMED} steps")
    check(v_launches["fused_simple_aug"] == VARIANT_WARMUP + VARIANT_TIMED
          and sum(v_launches.values()) == v_launches["fused_simple_aug"],
          "X3D PALLAS_AUG: fused_simple_aug was not launched once a step")


def moco_path(tconfig, dev) -> None:
    """Phase 7d: the moco_knn_minik400.yaml step (moco_steps) over enough
    steps to wrap the queue's pointer."""
    mcfg = one_card_cfg(tconfig, MOCO_CONFIG)
    per_step = mcfg.DATA.BATCHSIZE_PER_GPU
    extra = mcfg.CONTRASTIVE.QUEUE_LEN // per_step - WARMUP_STEPS - TIMED_STEPS  # to the wrap
    check(mcfg.CONTRASTIVE.KNN_BATCH_STATS, "the MoCo preset no longer probes on batch statistics")
    _, _, moco_launches, _ = moco_steps(mcfg, MOCO_EPOCH, WARMUP_STEPS, TIMED_STEPS, max(extra, 0), dev)
    check(not any(moco_launches.values()), "the MoCo step launched a kernel: its path has none")


def x3d_entry(tconfig) -> None:
    """Phase 8's X3D run: X3D_M_K400.yaml through the entry point, one
    epoch of X3D_RUN_VIDEOS synthetic videos, a profiler window over the
    second iteration; no kernel launched."""
    import shutil

    xcfg = one_card_cfg(tconfig, X3D_CONFIG)
    shutil.rmtree(X3D_RUN_DIR, ignore_errors=True)
    x3d = run_entry_point(["TPU.PROFILE_DIR", f"{X3D_RUN_DIR}/profile", "TPU.PROFILE_START", "0",
                           "TPU.PROFILE_STEPS", "1"], "X3D-M preset, 1 epoch", X3D_CONFIG, X3D_RUN_DIR,
                          X3D_RUN_OVERRIDES)
    n_iter = len(x3d["iter_s"])
    print(f"[run] X3D preset: {n_iter} iterations, stats {x3d['stats']}, iterations "
          f"{[t * 1e3 for t in x3d['iter_s']]} ms, loader wait {[t * 1e3 for t in x3d['wait_s']]} ms, peak "
          f"allocated {x3d['peak_allocated_bytes']} bytes, launches {x3d['launches']}, {x3d['seconds']} s "
          f"with start-up")
    split = {stage: f"{s * 1e3 / n} ms x {n} ({s * 1e3} ms in all)" for stage, (s, n) in x3d["host_s"].items()}
    print(f"[run] X3D preset: host stages {split}")
    check(n_iter == X3D_RUN_VIDEOS // xcfg.DATA.BATCHSIZE_PER_GPU and x3d["start_step"] == 0,
          "X3D preset: wrong schedule")
    check(all(math.isfinite(v) for st in x3d["stats"] for v in st.values()), "X3D preset: a loss is not finite")
    check(not any(but_bn(x3d["launches"]).values()), "the X3D run launched a kernel other than BN's")
    prof = x3d.get("profile")
    check(prof is not None, "the X3D run's profile window did not close")
    print(f"[run] X3D preset profile window ({prof['steps']} iteration): wall {prof['wall_ms']} ms, device "
          f"busy {prof['busy_ms']} ms, idle share {prof['idle_share']}")


def moco_entry(tconfig, label="MoCo cc", config=MOCO_CC_CONFIG, run_dir=MOCO_RUN_DIR,
               overrides=MOCO_RUN_OVERRIDES, videos=MOCO_RUN_VIDEOS) -> None:
    """Phase 8's MoCo runs (moco_knn_minik400cc.yaml, or the preset
    ``config``): through the entry point, one epoch with the kNN probe, then
    a resume to 2 that starts from the saved model, momentum encoder, queue
    and pointer bit for bit."""
    from pathlib import Path

    import torch

    from advise_tpu_torch.engine.checkpoint import STATE_FILE
    from advise_tpu_torch.engine.train import ssl_digest

    ccfg = one_card_cfg(tconfig, config)
    iters = videos // ccfg.DATA.BATCHSIZE_PER_GPU
    m1, m2 = resumed_pair(f"{label} preset", config, run_dir, overrides, ["SOLVER.MAX_EPOCH", "1"],
                          ["SOLVER.MAX_EPOCH", "2"] + NO_SAVE, iters, 1)
    for rec in (m1, m2):
        check(not any(but_bn(rec["launches"]).values()), f"the {label} run launched a kernel other than BN's")
    saved = torch.load(Path(run_dir) / "checkpoints" / "Model_Epoch_0000" / STATE_FILE, map_location="cpu",
                       weights_only=False)
    saved_ssl = ssl_digest(saved["ssl"])
    print(f"[run] {label} ptr in Model_Epoch_0000 {int(saved['ssl']['ptr'])}; SSL state (momentum encoder, queue, "
          f"pointer, kNN bank) sha256 saved {saved_ssl}")
    check(int(saved["ssl"]["ptr"]) == iters * ccfg.DATA.BATCHSIZE_PER_GPU % ccfg.CONTRASTIVE.QUEUE_LEN,
          f"the {label} checkpoint's pointer is not where {iters} steps leave it")
    check(m1["ssl_sha256_end"] == saved_ssl,
          f"the saved {label} momentum encoder, queue or pointer differs from the first run's")


def advise_swin_entry(tconfig) -> None:
    """Phase 8's AdViSe run with the video_swin head: AdViSe.yaml at
    ADVISE_SWIN, SSL.TASK speed_byol, one epoch of 2 iterations; the twins
    (the Swin layer's among them) in its checkpoint; no kernel launched."""
    import shutil
    from pathlib import Path

    import torch

    from advise_tpu_torch.engine.checkpoint import STATE_FILE

    acfg = one_card_cfg(tconfig, ADVISE_CONFIG, ADVISE_SWIN)
    shutil.rmtree(ADVISE_SWIN_RUN_DIR, ignore_errors=True)
    adv = run_entry_point([], "AdViSe video_swin (SSL.TASK speed_byol), 1 epoch", ADVISE_CONFIG,
                          ADVISE_SWIN_RUN_DIR, ADVISE_SWIN_RUN_OVERRIDES)
    n_iter = len(adv["iter_s"])
    print(f"[run] AdViSe video_swin: {n_iter} iterations, stats {adv['stats']}, iterations "
          f"{[t * 1e3 for t in adv['iter_s']]} ms, loader wait {[t * 1e3 for t in adv['wait_s']]} ms, peak "
          f"allocated {adv['peak_allocated_bytes']} bytes, launches {adv['launches']}, {adv['seconds']} s "
          f"with start-up")
    check(n_iter == ADVISE_RUN_VIDEOS // acfg.DATA.BATCHSIZE_PER_GPU and adv["start_step"] == 0,
          "AdViSe video_swin: wrong schedule")
    check(all(math.isfinite(v) for st in adv["stats"] for v in st.values()), "AdViSe video_swin: not finite")
    check(not any(but_bn(adv["launches"]).values()),
          "the AdViSe video_swin run launched a kernel other than BN's")
    saved = torch.load(Path(ADVISE_SWIN_RUN_DIR) / "checkpoints" / "Model_Epoch_0000" / STATE_FILE,
                       map_location="cpu", weights_only=False)
    twin = saved["ssl"].get("ema_temporal", {})
    check(any(k.startswith("layer.blocks_") for k in twin) and saved["step"] == n_iter,
          "AdViSe video_swin: the checkpoint lacks the Swin layer's twin")


def advise_steps(acfg, label, warmup, timed, dev, profiled=False):
    """The AdViSe step of ``acfg`` (``step_run``: uint8 clips at the ingest
    geometry) on one card, warmup + timed steps (``time_steps``); prints
    each step, the median, clips/s, the peak memory and the parameter
    counts; with ``profiled`` one more step under torch.profiler. Returns
    (median ms, peak bytes, launches by kernel, tower unchanged, twins
    moved)."""
    import torch

    from advise_tpu_torch.engine.checkpoint import tensors_digest
    from advise_tpu_torch.solver.optimizer import classify_params
    from advise_tpu_torch.tools.compare_steps import step_run, time_steps

    run = step_run(acfg, dev, 3, ADVISE_EPOCH)
    state, model = run.state, run.state.model
    labels = classify_params(acfg, dict(model.named_parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    n_frozen = sum(p.numel() for n, p in model.named_parameters() if labels[n] == "frozen")
    b, k, t = acfg.DATA.BATCHSIZE_PER_GPU, acfg.DATA.NUM_CLIP, acfg.DATA.NUM_FRAMES
    tower0 = tensors_digest(model.spatial_encoder.state_dict())
    twins0 = {name: tensors_digest(v) for name, v in state.ssl.items()}
    print(f"[advise] {label}: {n_params} params ({n_frozen} frozen), SSL.TASK {acfg.SSL.TASK}, "
          f"FROM_SCRATCH {acfg.TM.FROM_SCRATCH}, PALLAS_AUG {acfg.TPU.PALLAS_AUG}, clips "
          f"{tuple(run.clips.shape)} uint8 -> crop {acfg.AUG.TARGET_SIZE}, {acfg.TPU.COMPUTE_DTYPE}, "
          f"lr {run.lr} at epoch {ADVISE_EPOCH}")

    def after_step(i, vals, ms):
        print(f"[advise] {label} step {i}: {vals} ({ms} ms)")
        check(all(math.isfinite(v) for v in vals.values()), f"AdViSe {label} step {i} is not finite")

    with bn_on_kernels(f"AdViSe {label}", warmup + timed, *run_models(run)):
        median_ms, _, peak, launches = time_steps(run, warmup, timed, counted_kernels(), after_step=after_step)
    check(state.step == warmup + timed, f"the AdViSe {label} state did not advance")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), f"AdViSe {label} params not finite")
    tower_same = tensors_digest(model.spatial_encoder.state_dict()) == tower0
    twins_moved = all(tensors_digest(v) != twins0[name] for name, v in state.ssl.items())
    print(f"[advise] {label}: median step {median_ms} ms over {timed} steps, {b * k * 1e3 / median_ms} "
          f"clips/s ({b} videos x {k} clips x {t} frames), peak allocated {peak} bytes, launches "
          f"{launches}, tower unchanged {tower_same}, twins {sorted(state.ssl)} moved {twins_moved}")
    if profiled:
        profile_step(label, run.call, "advise")
    del run, state, model
    gc.collect()
    torch.cuda.empty_cache()
    return median_ms, peak, launches, tower_same, twins_moved


def mae_forward(tconfig, dev) -> None:
    """Phase 4's MAE check: mae_vismask_minik400.yaml's model at its width on
    MAE_SMALL_CLIPS clips, bf16 on the card against the same weights'
    float32 forward on the CPU, both with the same random masks (drawn on
    the CPU, handed to both): the prediction and the VIS reconstruction."""
    import numpy as np
    import torch

    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.models.masked import random_masking
    from advise_tpu_torch.models.mvit import patch_grid

    cfg = one_card_cfg(tconfig, MAE_CONFIG)
    ref_cfg = cfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    size = cfg.DATA.TRAIN_CROP_SIZE
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (MAE_SMALL_CLIPS, cfg.DATA.NUM_FRAMES, size, size, 3)).astype(np.float32))
    masking = random_masking(MAE_SMALL_CLIPS, patch_grid(cfg), cfg.AUG.MASK_RATIO,
                             generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = build_model(ref_cfg, "cpu", seed=0).eval()(x, masking=masking)
        card = build_model(cfg, dev, seed=0).eval()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = card(x.to(dev).bfloat16(), masking=tuple(m.to(dev) for m in masking))
    for out_name, a, r in (("pixel prediction", got[0][0], want[0][0]), ("VIS reconstruction", got[4][2], want[4][2])):
        check(tuple(a.shape) == tuple(r.shape), f"MAE {out_name} has shape {tuple(a.shape)}")
        rel = float((a.float().cpu() - r).abs().max() / r.abs().max())
        # bf16 activations through 8 encoder and 2 decoder blocks, as the other phase-4 forwards
        print(f"[small] MAE (mae_vismask) {out_name} {tuple(a.shape)}, {int(masking[0].shape[1])} of "
              f"{masking[1].shape[1]} tokens visible: max rel err vs CPU float32 {rel} (bound 5e-2)")
        check(math.isfinite(rel) and rel <= 5e-2, f"the card's MAE {out_name} disagrees with the CPU")
    del card
    torch.cuda.empty_cache()


def mvit_v2_forward(tconfig, dev) -> None:
    """Phase 4's MViTv2 check: the MViT-S trunk of MViT_S_rev_masked.yaml as
    a 400-class classifier with REL_POS_SPATIAL, REL_POS_TEMPORAL,
    RESIDUAL_POOLING and DIM_MUL_IN_ATT, on 2 clips of 8 frames at 112^2:
    bf16 on the card against float32 on the CPU, eval mode; the blocks run
    the dense chain (rel-pos turns flash off) and launch no kernel."""
    import numpy as np
    import torch

    from advise_tpu_torch.models import build_model

    cfg = one_card_cfg(tconfig, MVIT_S_CONFIG, MVIT_V2)
    ref_cfg = cfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, cfg.DATA.NUM_FRAMES, 112, 112, 3)).astype(np.float32))
    counters = counted_kernels()
    with torch.no_grad():
        want = build_model(ref_cfg, "cpu", seed=0).eval()(x)
        card = build_model(cfg, dev, seed=0).eval()
        for fn in counters:
            fn.launches = 0
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = card(x.to(dev).bfloat16())
    n_params = sum(p.numel() for p in card.parameters())
    check(tuple(got.shape) == tuple(want.shape) == (2, cfg.MODEL.NUM_CLASSES), f"MViTv2 logits {tuple(got.shape)}")
    rel = float((got.float().cpu() - want).abs().max() / want.abs().max())
    print(f"[small] MViTv2-S ({n_params} params; rel-pos, residual pooling, DIM_MUL_IN_ATT) {tuple(x.shape)} -> "
          f"{tuple(got.shape)} (bf16 on the card): max rel err vs CPU float32 {rel} (bound 5e-2), launches "
          f"{ {fn.__name__: fn.launches for fn in counters} }")
    check(math.isfinite(rel) and rel <= 5e-2, "the card's MViTv2 forward disagrees with the CPU")
    check(not any(fn.launches for fn in counters), "the MViTv2 forward launched a kernel: rel-pos runs dense")
    del card
    torch.cuda.empty_cache()


def mae_steps(mcfg, label, warmup, timed, dev):
    """The MAE step of ``mcfg`` (``step_run``: uint8 clips through OnlyCrop,
    the masks drawn in the model from the step's generator, AdamW), warmup +
    timed steps (``time_steps``), then one profiled step; prints each step,
    the median, clips/s, the peak memory and the visible tokens. Returns
    (median ms, peak bytes, launches by kernel)."""
    import torch

    from advise_tpu_torch.models.mvit import patch_grid
    from advise_tpu_torch.tools.compare_steps import step_run, time_steps

    run = step_run(mcfg, dev, 7, MAE_EPOCH)
    model = run.state.model
    n_params = sum(p.numel() for p in model.parameters())
    b, t = mcfg.DATA.BATCHSIZE_PER_GPU, mcfg.DATA.NUM_FRAMES
    grid = patch_grid(mcfg)
    tokens = math.prod(grid)
    visible = max(int(tokens * (1 - mcfg.AUG.MASK_RATIO)), 2)
    print(f"[mae] {label}: {n_params} params, clips {tuple(run.clips.shape)} uint8 -> OnlyCrop "
          f"{mcfg.AUG.TARGET_SIZE}, encoder {mcfg.MVIT.EMBED_DIM} wide x {model.n_blocks} blocks "
          f"({mcfg.MVIT.NUM_HEADS} heads), decoder {mcfg.MASK.DECODER_EMBED_DIM} wide x "
          f"{mcfg.MASK.DECODER_DEPTH}, grid {grid}: {visible} of {tokens} tokens visible, "
          f"{mcfg.TPU.COMPUTE_DTYPE}, VIS_MASK {mcfg.VIS_MASK.ENABLE}, {mcfg.SOLVER.OPTIMIZING_METHOD}, "
          f"lr {run.lr} at epoch {MAE_EPOCH}")
    check((visible, tokens) == MAE_VISIBLE[label], f"{label}: {visible} of {tokens} tokens visible")

    def after_step(i, vals, ms):
        print(f"[mae] {label} step {i}: {vals} ({ms} ms)")
        check(all(math.isfinite(v) for v in vals.values()), f"{label} step {i} is not finite")

    median_ms, step_ms, peak, launches = time_steps(run, warmup, timed, counted_kernels(), after_step=after_step)
    check(run.state.step == warmup + timed, f"the {label} state did not advance")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), f"{label} params not finite")
    print(f"[mae] {label}: median step {median_ms} ms over {timed} steps (all: {step_ms}), "
          f"{b * 1e3 / median_ms} clips/s ({b} clips x {t} frames), peak allocated {peak} bytes, "
          f"launches {launches}")
    profile_step(f"{label} step", run.call, "mae")
    del run, model
    gc.collect()
    torch.cuda.empty_cache()
    return median_ms, peak, launches


def mae_path(tconfig, dev) -> None:
    """Phase 7f: the mae_vismask_minik400.yaml MAE step at one card, then
    the same YAML at ViT-B/16 MAE widths (VITB_MAE); no kernel launched: the
    MAE blocks run the dense chain, as JAX's do."""
    for label, over in (("mae_vismask", None), ("ViT-B MAE", VITB_MAE)):
        mcfg = one_card_cfg(tconfig, MAE_CONFIG, over)
        _, _, launches = mae_steps(mcfg, label, WARMUP_STEPS, TIMED_STEPS, dev)
        check(not any(launches.values()), f"the {label} step launched a kernel: its path has none")


def mae_entry(tconfig) -> None:
    """Phase 8's MAE run: mae_vismask_minik400.yaml through the entry point,
    2 epochs then a resume to 3 (the model bit for bit by sha256), and its
    VIS_MASK dump: 4 triples an epoch, float32 [3, T / 2, H, W, 3], the
    masked input zero on exactly the hidden patches and the reconstruction
    EQUAL to the input on every visible one."""
    import os
    from pathlib import Path

    import numpy as np
    import torch

    from advise_tpu_torch.engine.checkpoint import STATE_FILE, tensors_digest
    from advise_tpu_torch.models.mvit import patch_grid
    from advise_tpu_torch.utils.visualization import vis_dir

    mcfg = one_card_cfg(tconfig, MAE_CONFIG)
    iters = MAE_RUN_VIDEOS // mcfg.DATA.BATCHSIZE_PER_GPU
    m1, m2 = resumed_pair("MAE preset", MAE_CONFIG, MAE_RUN_DIR, MAE_RUN_OVERRIDES, ["SOLVER.MAX_EPOCH", "2"],
                          ["SOLVER.MAX_EPOCH", "3"], iters, 2)
    for rec in (m1, m2):
        check(not any(but_bn(rec["launches"]).values()), "the MAE run launched a kernel other than BN's")
    saved = tensors_digest(torch.load(Path(MAE_RUN_DIR) / "checkpoints" / "Model_Epoch_0001" / STATE_FILE,
                                      map_location="cpu", weights_only=False)["model"])
    print(f"[run] MAE model sha256 of Model_Epoch_0001 {saved}")
    check(m1["model_sha256_end"] == saved, "the saved MAE model differs from the first run's")
    mcfg.LOGDIR = MAE_RUN_DIR
    out = vis_dir(mcfg)
    names = sorted(n for n in os.listdir(out) if n.endswith(".npy"))
    want = [f"vis_{e}_{i}.npy" for e in range(3) for i in range(4)]
    check(names == want, f"the VIS_MASK dump holds {names}, not {want}")
    t, h, w = patch_grid(mcfg)
    p = mcfg.DATA.TRAIN_CROP_SIZE // h
    visible = max(int(t * h * w * (1 - mcfg.AUG.MASK_RATIO)), 2)
    hidden_counts = []
    for name in names:
        triple = np.load(os.path.join(out, name))
        check(triple.shape == (3, t, mcfg.DATA.TRAIN_CROP_SIZE, mcfg.DATA.TRAIN_CROP_SIZE, 3)
              and triple.dtype == np.float32, f"VIS_MASK {name} has shape {triple.shape} {triple.dtype}")
        raw, masked, rec = (v.reshape(t, h, p, w, p, 3).transpose(0, 1, 3, 2, 4, 5).reshape(t * h * w, -1)
                            for v in triple)
        hidden = np.all(masked == 0, axis=1)
        hidden_counts.append(int(hidden.sum()))
        check(np.array_equal(masked[~hidden], raw[~hidden]), f"VIS_MASK {name}: the masked input is not the input")
        check(np.array_equal(rec[~hidden], raw[~hidden]),
              f"VIS_MASK {name}: the reconstruction differs from the input on a visible patch")
        check(np.isfinite(rec).all(), f"VIS_MASK {name}: the reconstruction is not finite")
    mp4s = sorted(n for n in os.listdir(out) if n.endswith(".mp4"))
    print(f"[run] MAE VIS_MASK dump in {out}: {len(names)} .npy files and {len(mp4s)} .mp4 (cv2 where it imports), "
          f"shape {triple.shape}; hidden patches a clip {hidden_counts} (expected {t * h * w - visible} of "
          f"{t * h * w}); reconstruction equal to the input on every visible patch")
    check(all(c == t * h * w - visible for c in hidden_counts), "VIS_MASK: the hidden patches are not the masked ones")


def maskfeat_entries(tconfig) -> None:
    """Phase 8's MaskFeat runs: maskfeat_minik400.yaml (the loader's block
    masks, HOG targets, REMAT) for one epoch through the entry point, then
    maskfeat_probe_minik400.yaml with RESUME at its checkpoint: a linear
    probe of the MViT (the encoder's parameters kept bit for bit, the head
    trained), then action_infer; no kernel launched on either."""
    import shutil
    from pathlib import Path

    import torch

    from advise_tpu_torch.engine.checkpoint import STATE_FILE

    fcfg = one_card_cfg(tconfig, MASKFEAT_CONFIG)
    pcfg = one_card_cfg(tconfig, MASKFEAT_PROBE_CONFIG)
    shutil.rmtree(MASKFEAT_RUN_DIR, ignore_errors=True)
    shutil.rmtree(MASKFEAT_PROBE_RUN_DIR, ignore_errors=True)
    mf = run_entry_point([], "MaskFeat preset, 1 epoch", MASKFEAT_CONFIG, MASKFEAT_RUN_DIR, MASKFEAT_RUN_OVERRIDES)
    prb = run_entry_point([], "MaskFeat linear probe + action_infer", MASKFEAT_PROBE_CONFIG, MASKFEAT_PROBE_RUN_DIR,
                          MASKFEAT_PROBE_OVERRIDES)
    for rec, label, cfg in ((mf, "MaskFeat", fcfg), (prb, "MaskFeat probe", pcfg)):
        print(f"[run] {label}: stats {rec['stats']}, iterations {[t * 1e3 for t in rec['iter_s']]} ms, loader wait "
              f"{[t * 1e3 for t in rec['wait_s']]} ms, peak allocated {rec['peak_allocated_bytes']} bytes, "
              f"launches {rec['launches']}, {rec['seconds']} s with start-up")
        check(len(rec["iter_s"]) == MASKFEAT_RUN_VIDEOS // cfg.DATA.BATCHSIZE_PER_GPU and rec["start_step"] == 0,
              f"{label}: wrong schedule")
        check(all(math.isfinite(v) for st in rec["stats"] for v in st.values()), f"{label}: not finite")
        check(not any(but_bn(rec["launches"]).values()), f"the {label} run launched a kernel other than BN's")
    inf = prb["action_infer"]
    views = pcfg.INFER.NUM_CLIPS * pcfg.INFER.NUM_CROPS
    print(f"[run] MaskFeat action_infer: {inf['total']} videos, {inf['views']} views in {inf['batches']} batches, "
          f"{inf['seconds']} s, {inf['views_per_s']} views/s, median batch {inf['batch_ms_median']} ms, "
          f"acc {inf['acc']}")
    check(inf["total"] == MASKFEAT_RUN_VIDEOS and inf["views"] == MASKFEAT_RUN_VIDEOS * views,
          "MaskFeat action_infer did not see every view of every video")
    pretrained = torch.load(Path(MASKFEAT_RUN_DIR) / "checkpoints" / "Model_Epoch_0000" / STATE_FILE,
                            map_location="cpu", weights_only=False)["model"]
    probed = torch.load(Path(MASKFEAT_PROBE_RUN_DIR) / "checkpoints" / "Model_Epoch_0000" / STATE_FILE,
                        map_location="cpu", weights_only=False)["model"]
    frozen = [k for k in probed if "head" not in k and f"encoder.{k}" in pretrained]
    print(f"[run] MaskFeat probe: {len(frozen)} of {len(probed)} tensors from the MaskFeat encoder")
    check(len(frozen) > 0 and all(torch.equal(probed[k], pretrained[f"encoder.{k}"]) for k in frozen),
          "the MaskFeat probe's encoder differs from the pretrain checkpoint")


def contrastive_path(tconfig, dev, byol_ms, byol_peak) -> dict:
    """Phase 7g: the BYOL preset's step at full width under each of
    CON_VARIANTS (``step_run`` / ``time_steps``: uint8 clips through the
    preset's aug, or clip_aug), CON_WARMUP + CON_TIMED steps each: median
    ms, peak memory and the K1/K2 launches, which must equal the variant's
    schedule; finite losses and moving parameters; one more step of each of
    CON_PROFILED under torch.profiler. SwAV starts from a full
    queue of unit rows at epoch 15 (a later epoch's state), so that the gate
    is open from the first step; mem draws its rows from the step's
    generator and takes each video's time from ``time_idx``. The SEQUENTIAL
    step's peak is read beside the batched BYOL step's of phase 5 (same
    call). Returns the K1/K2 launches of all the variants' steps."""
    import torch

    from advise_tpu_torch.engine.contrastive import l2_normalize
    from advise_tpu_torch.tools.compare_steps import step_run, time_steps

    n_steps = CON_WARMUP + CON_TIMED
    totals = {"stem_conv_fwd": 0, "stem_conv_wgrad": 0}
    for label, over, per_step, loss_name in CON_VARIANTS:
        ccfg = one_card_cfg(tconfig, BYOL_CONFIG, over)
        epoch = SWAV_EPOCH if ccfg.CONTRASTIVE.TYPE == "swav" else EPOCH_EXACT
        run = step_run(ccfg, dev, 7, epoch)
        state, model = run.state, run.state.model
        b = ccfg.DATA.BATCHSIZE_PER_GPU
        ssl = state.ssl
        if "queue_swav" in ssl:
            rows = torch.randn(ssl["queue_swav"].shape, generator=torch.Generator(device=dev).manual_seed(3),
                               device=dev)
            ssl["queue_swav"] = l2_normalize(rows)
            ssl["swav_started"] = torch.ones((), dtype=torch.bool, device=dev)
        sizes = {n: f"{tuple(v.shape)} {v.dtype} ({v.numel() * v.element_size()} bytes)"
                 for n, v in ssl.items() if isinstance(v, torch.Tensor) and v.ndim > 1}
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        gates = []

        def after_step(i, vals, ms):
            if "queue_swav" in ssl:
                gates.append(vals.get("swav_gate"))  # the share of the views whose gate the loss found open
            print(f"[con] {label} step {i}: {vals} ({ms} ms)")
            check(all(math.isfinite(v) for v in vals.values()), f"{label} step {i} is not finite")
            check(loss_name in vals, f"{label} step {i} reports no {loss_name}")

        times = torch.rand(b, generator=torch.Generator().manual_seed(5)).to(dev)
        with bn_on_kernels(label, CON_WARMUP + CON_TIMED, *run_models(run)):
            median_ms, step_ms, peak, launches = time_steps(
                run, CON_WARMUP, CON_TIMED, counted_kernels(),
                infos_fn=lambda i: {"item_id": torch.arange(b, device=dev) + i * b, "time_idx": times},
                after_step=after_step)
        got = (launches["stem_conv_fwd"], launches["stem_conv_wgrad"])
        want = (per_step[0] * n_steps, per_step[1] * n_steps)
        moved = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
        print(f"[con] {label} ({over}): median step {median_ms} ms over {CON_TIMED} steps (all: {step_ms}), "
              f"{2 * b * 1e3 / median_ms} clip-views/s, peak allocated {peak} bytes, K1/K2 launches {got} "
              f"(schedule {want}), other launches {launches}, {moved} of {len(before)} parameters moved, "
              f"state {sizes}")
        check(got == want, f"{label}: the K1/K2 launches differ from the schedule")
        totals = {name: n + launches[name] for name, n in totals.items()}
        check(not any(n for name, n in launches.items() if name not in ("stem_conv_fwd", "stem_conv_wgrad")),
              f"{label}: a kernel off the path was launched")
        check(moved > 0 and all(bool(torch.isfinite(p).all()) for p in model.parameters()),
              f"{label}: the parameters did not move or are not finite")
        if "queue_swav" in ssl:
            print(f"[con] {label}: the loss's swav_gate at each step {gates}")
            check(gates == [1.0] * n_steps, "swav: the queue's gate was not open from the first step")
        if ccfg.CONTRASTIVE.SEQUENTIAL:
            print(f"[con] CONTRASTIVE.SEQUENTIAL peak {peak} bytes against the batched BYOL step's {byol_peak} "
                  f"(phase 5, this call): {peak / byol_peak} of it; median {median_ms} ms against {byol_ms} ms")
        if label in CON_PROFILED:
            profile_step(label, run.call, "con")
        del run, state, model, ssl, before
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def speed_sequential(tconfig, dev, speed_ms, speed_peak) -> int:
    """Phase 7g's TRAIN.SEQUENTIAL: SpeedPro_R50.yaml's speed step at full
    width (8 videos x 4 clips, K3 in the aug), one clip of each video at a
    time, CON_WARMUP + CON_TIMED steps: median ms, peak memory against the
    batched speed step of phase 6 (same call), K3 once a step, then one
    step under torch.profiler. Returns K3's launches."""
    import torch

    from advise_tpu_torch.tools.compare_steps import step_run, time_steps

    scfg = one_card_cfg(tconfig, SPEED_CONFIG, {"TRAIN.SEQUENTIAL": True})
    run = step_run(scfg, dev, 8, SPEED_EPOCH)

    def after_step(i, vals, ms):
        print(f"[seq] TRAIN.SEQUENTIAL speed step {i}: {vals} ({ms} ms)")
        check(all(math.isfinite(v) for v in vals.values()), f"TRAIN.SEQUENTIAL step {i} is not finite")

    with bn_on_kernels("TRAIN.SEQUENTIAL speed", CON_WARMUP + CON_TIMED, *run_models(run)):
        median_ms, step_ms, peak, launches = time_steps(run, CON_WARMUP, CON_TIMED, counted_kernels(),
                                                        after_step=after_step)
    n_steps = CON_WARMUP + CON_TIMED
    print(f"[seq] TRAIN.SEQUENTIAL speed ({scfg.DATA.BATCHSIZE_PER_GPU} videos x {scfg.DATA.NUM_CLIP} clips, "
          f"one clip at a time): median step {median_ms} ms over {CON_TIMED} steps (all: {step_ms}), peak "
          f"allocated {peak} bytes against the batched speed step's {speed_peak} (phase 6, this call): "
          f"{peak / speed_peak} of it; median {median_ms} ms against {speed_ms} ms; launches {launches}")
    check(launches["fused_simple_aug"] == n_steps, "TRAIN.SEQUENTIAL: K3 was not launched once a step")
    check(run.state.step == n_steps, "TRAIN.SEQUENTIAL: the state did not advance")
    profile_step("TRAIN.SEQUENTIAL speed", run.call, "seq")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return launches["fused_simple_aug"]


def solver_chains(tconfig, dev) -> None:
    """Phase 7g's solver: one step each of SOLVER_VARIANTS on the MAE
    preset (finite stats, moving parameters; with layer decay the lr
    scales of the tree's depths), then the steps_with_relative_lrs policy
    at its boundaries on the BYOL preset."""
    import torch

    from advise_tpu_torch.solver.lr_policy import get_lr_at_epoch
    from advise_tpu_torch.tools.compare_steps import step_run, time_steps

    for label, over in SOLVER_VARIANTS:
        mcfg = one_card_cfg(tconfig, MAE_CONFIG, over)
        run = step_run(mcfg, dev, 9, 1.0)
        before = {n: p.detach().clone() for n, p in run.state.model.named_parameters()}
        stats = {}
        median_ms, step_ms, peak, launches = time_steps(run, 0, 1, counted_kernels(),
                                                        after_step=lambda i, vals, ms: stats.update(vals))
        moved = sum(not torch.equal(p, before[n]) for n, p in run.state.model.named_parameters())
        scales = sorted(set(run.bundle.lr_scales.values()))
        print(f"[solver] {label} ({over}: {type(run.bundle.tx).__name__}): stats {stats}, {step_ms[0]} ms, "
              f"peak allocated {peak} bytes, {moved} of {len(before)} parameters moved, lr scales {scales}")
        check(stats and all(math.isfinite(v) for v in stats.values()) and moved > 0,
              f"solver {label}: stats not finite or nothing moved")
        check(not any(launches.values()), f"solver {label}: a kernel was launched")
        if "SOLVER.LAYER_DECAY" in over:
            check(len(scales) > 2, "layer decay: the lr scales do not spread over the depths")
        del run, before
        gc.collect()
        torch.cuda.empty_cache()
    lcfg = one_card_cfg(tconfig, BYOL_CONFIG, {"SOLVER.LR_POLICY": "steps_with_relative_lrs",
                                               "SOLVER.STEPS": [0, 100, 150], "SOLVER.LRS": [1.0, 0.1, 0.01]})
    base = lcfg.SOLVER.BASE_LR
    lrs = {e: get_lr_at_epoch(lcfg, e) for e in (0.0, 5.0, 99.99, 100.0, 149.99, 150.0, 199.99)}
    print(f"[solver] steps_with_relative_lrs over STEPS [0, 100, 150], LRS [1, 0.1, 0.01], BASE_LR {base}, "
          f"warm-up {lcfg.SOLVER.WARMUP_EPOCHS} from {lcfg.SOLVER.WARMUP_START_LR}: {lrs}")
    check(lrs[99.99] == base and lrs[100.0] == 0.1 * base and lrs[149.99] == 0.1 * base
          and lrs[150.0] == 0.01 * base and lrs[199.99] == 0.01 * base, "steps_with_relative_lrs boundaries")
    check(lrs[0.0] == lcfg.SOLVER.WARMUP_START_LR and lrs[0.0] < lrs[5.0] < base, "the warm-up is not linear")


def contrastive_entries(tconfig) -> None:
    """Phase 8's SwAV and 2-D memory-bank runs (CON_ENTRIES) through the
    entry point on the BYOL preset: one epoch from epoch 15 with the kNN
    probe, then a resume to a second that starts from the saved model and
    SSL state (the queue and swav_started, or the bank) bit for bit
    (``resumed_pair``), the saved SSL state the first run's; K1/K2
    launches by the schedule; SwAV's queue shut in the first epoch and open
    in the second (``swav_started`` in the checkpoints)."""
    from pathlib import Path

    import torch

    from advise_tpu_torch.engine.checkpoint import STATE_FILE
    from advise_tpu_torch.engine.train import ssl_digest

    for label, run_dir, over in CON_ENTRIES:
        ccfg = one_card_cfg(tconfig, BYOL_CONFIG, over)
        iters = CON_RUN_VIDEOS // ccfg.DATA.BATCHSIZE_PER_GPU
        r1, r2 = resumed_pair(label, BYOL_CONFIG, run_dir, CON_RUN_OVERRIDES + as_argv(over),
                              ["SOLVER.MAX_EPOCH", "16"], ["SOLVER.MAX_EPOCH", "17"], iters, 1, start_epoch=15)
        for rec, run in ((r1, "first run"), (r2, "resumed run")):
            got = (rec["launches"]["stem_conv_fwd"], rec["launches"]["stem_conv_wgrad"])
            want = (iters + RUN_KNN_BATCHES, iters)  # + the probe batch's forward
            print(f"[run] {label} {run}: K1/K2 launches {got} (expected {want})")
            check(got == want, f"{label} {run}: K1/K2 launches differ from the schedule")
        ckpt = Path(run_dir) / "checkpoints"
        saved = torch.load(ckpt / "Model_Epoch_0015" / STATE_FILE, map_location="cpu", weights_only=False)
        final = torch.load(ckpt / "Model_Epoch_0016" / STATE_FILE, map_location="cpu", weights_only=False)
        saved_ssl = ssl_digest(saved["ssl"])
        state_text = {n: (tuple(v.shape), str(v.dtype)) for n, v in final["ssl"].items()
                      if isinstance(v, torch.Tensor)}
        print(f"[run] {label}: SSL state {state_text}; SSL sha256 saved after epoch 15 {saved_ssl}")
        check(r1["ssl_sha256_end"] == saved_ssl, f"the saved {label} SSL state differs from the first run's")
        if "swav_started" in saved["ssl"]:
            gates = [[st.get("swav_gate") for st in rec["stats"]] for rec in (r1, r2)]
            print(f"[run] {label}: swav_started {bool(saved['ssl']['swav_started'])} after epoch 15, "
                  f"{bool(final['ssl']['swav_started'])} after epoch 16; the loss's swav_gate in each "
                  f"iteration of epoch 15 {gates[0]}, of epoch 16 {gates[1]}")
            check(not bool(saved["ssl"]["swav_started"]) and bool(final["ssl"]["swav_started"]),
                  f"{label}: the queue did not open in the second epoch")
            check(gates == [[0.0] * iters, [1.0] * iters], f"{label}: the loss's gate was not shut in epoch 15 "
                  "and open in epoch 16")
        else:
            check(tuple(final["ssl"]["memory"].shape) == (ccfg.CONTRASTIVE.LENGTH, 4, ccfg.CONTRASTIVE.DIM),
                  f"{label}: the checkpoint's bank has the wrong shape")
            check(not torch.equal(final["ssl"]["memory"], saved["ssl"]["memory"]), f"{label}: the bank did not move")


def ra_exact_small(tconfig, dev) -> None:
    """Phase 4's op-exact RandAugment: the BYOL preset with AUG.FUSED_RA
    False (bicubic, RE_PROB 0.25, float32 out) on RA_SMALL_CLIPS uint8 clips
    of 32 frames at the ingest 298x224, the card against the CPU with the
    same parameters, drawn on the CPU. First each of the 15 ops alone on the
    CPU's RandomResizedCrop of the clips (at magnitude 7 with each clip's
    drawn sign), then the whole pipeline with the preset's draws. The
    geometric ops take sin/cos and sample positions in float32, so a value
    next to a rounding boundary may move one uint8 step: at most 0.1 % of
    the values, by at most one step, alone and in the pipeline."""
    import numpy as np
    import torch

    from advise_tpu_torch.data import build_device_aug, ingest_geometry
    from advise_tpu_torch.data.device_aug import resized_crop_clips
    from advise_tpu_torch.data.rand_augment import NUM_OPS

    cfg = one_card_cfg(tconfig, BYOL_CONFIG, {**RA_EXACT, "TPU.AUG_COMPUTE_OUT": False})
    aug = build_device_aug(cfg, "train")
    n, t = RA_SMALL_CLIPS, cfg.DATA.NUM_FRAMES
    w_in, h_in = ingest_geometry(cfg, "train")
    batch = torch.from_numpy(np.random.default_rng(12).integers(0, 256, (n, 1, t, h_in, w_in, 3), dtype=np.uint8))
    params = aug.sample(n, t, h_in, w_in, 3, torch.Generator().manual_seed(4))
    crops = torch.clamp(resized_crop_clips(batch[:, 0].float(), params["box"], aug.size), 0.0, 255.0)
    one = copy.copy(aug.ra)
    one.n = 1
    worst = []
    for op in range(NUM_OPS):
        plan = {"sel": torch.full((n, 1), op), "m_eff": torch.full((n, 1), 7.0), "sign": params["plan"]["sign"][:, :1]}
        want = one.apply(crops, plan)
        got = one.apply(crops.to(dev), {k: v.to(dev) for k, v in plan.items()}).cpu()
        diff = (got - want).abs()
        worst.append((op, float(diff.max()), float((diff > 0).float().mean())))
        check(float(diff.max()) <= 1.0 and worst[-1][2] <= 1e-3, f"the card's op-exact op {op} disagrees with the CPU")
    print(f"[small] op-exact RandAugment ops alone ({aug.ra.method}) on {tuple(crops.shape)}: card vs CPU (op, max abs "
          f"err in uint8 steps, share differing) {worst} (bounds 1 step, 1e-3)")
    step = 1.0 / (255.0 * min(cfg.DATA.STD)) + 1e-5  # one uint8 step, normalized
    want = aug.apply(batch, params)
    got = aug.apply(batch.to(dev), {**params, "plan": {k: v.to(dev) for k, v in params["plan"].items()}}).cpu()
    diff = (got - want).abs()
    share = float((diff > 1e-4).float().mean())
    print(f"[small] op-exact 'aa' ({cfg.AUG.AA_TYPE}, {aug.ra.method}) {tuple(batch.shape)} -> {tuple(got.shape)}, "
          f"ops {params['plan']['sel'].tolist()}: card vs CPU max abs err {float(diff.max())} (bound one step, "
          f"{step}), share beyond 1e-4 {share} (bound 1e-3)")
    check(tuple(got.shape) == (n, 1, t, cfg.AUG.TARGET_SIZE, cfg.AUG.TARGET_SIZE, 3), "op-exact aug shape")
    check(float(diff.max()) <= step and share <= 1e-3, "the card's op-exact aug disagrees with the CPU")


def mvit_knobs_forward(tconfig, dev) -> None:
    """Phase 4's A 20 knobs: MViT-S as a classifier with MVIT_KNOBS on, in
    the plain and the reversible walk, 2 clips of 8 frames at 112^2, eval
    mode, bf16 on the card (flash attention: K4 once a block) against
    float32 on the CPU."""
    import numpy as np
    import torch

    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.ops import flash_attention as fl

    for walk, knobs in MVIT_KNOBS:
        cfg = one_card_cfg(tconfig, MVIT_S_CONFIG, {**MVIT_KNOB_BASE, **knobs})
        ref_cfg = cfg.clone()
        ref_cfg.TPU.COMPUTE_DTYPE = "float32"
        x = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (2, cfg.DATA.NUM_FRAMES, 112, 112, 3)).astype(np.float32))
        with torch.no_grad():
            want = build_model(ref_cfg, "cpu", seed=0).eval()(x)
            card = build_model(cfg, dev, seed=0).eval()
            fl.flash_mha_fwd.launches = fl.flash_f32_fwd.launches = 0
            with torch.autocast("cuda", dtype=torch.bfloat16):
                got = card(x.to(dev).bfloat16())
        torch.cuda.synchronize()
        rel = float((got.float().cpu() - want).abs().max() / want.abs().max())
        dims = head_dims(card)
        sched = k4_schedule(card, False, 0, backward=False)
        want_launches = (sched["flash_mha_fwd"], sched["flash_f32_fwd"])
        launches = (fl.flash_mha_fwd.launches, fl.flash_f32_fwd.launches)
        print(f"[small] MViT-S {walk} with {knobs} ({sum(p.numel() for p in card.parameters())} params) "
              f"{tuple(x.shape)} -> {tuple(got.shape)} (bf16 on the card): max rel err vs CPU float32 {rel} "
              f"(bound 5e-2); head dims {dims}: K4 forward launches (bf16 pair, float32 pair above d "
              f"{max(fl.TILES)}) {launches}, by k4_schedule {want_launches}")
        check(tuple(got.shape) == (2, cfg.MODEL.NUM_CLASSES), f"MViT-S {walk} logits {tuple(got.shape)}")
        check(math.isfinite(rel) and rel <= 5e-2, f"the card's MViT-S {walk} with the A 20 knobs disagrees")
        check(launches == want_launches, f"MViT-S {walk}: K4 not launched once a block by its route")
        del card
        torch.cuda.empty_cache()


def fuse_inter_forward(tconfig, dev) -> None:
    """Phase 4's MVIT.REV.RESPATH_FUSE concat_linear_ln at a pretrain depth:
    MViT_S_rev_masked.yaml's MaskMViT, reversible, with FUSE_INTER on 2
    clips of 8 frames at 112^2 and the loader's block masks, eval mode, its
    HOG predictions from ``fuse_inter_1`` (a float32 projection and
    LayerNorm whatever autocast says) in bf16 on the card against float32
    on the CPU; K4 once a block by its route."""
    import numpy as np
    import torch

    from advise_tpu_torch.data.masking import build_mask_generator
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.ops import flash_attention as fl

    cfg = one_card_cfg(tconfig, MVIT_S_CONFIG, FUSE_INTER)
    ref_cfg = cfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, cfg.DATA.NUM_FRAMES, 112, 112, 3)).astype(np.float32))
    gen = build_mask_generator(cfg)
    mask = torch.from_numpy(np.stack([gen(rng) for _ in range(2)]).reshape(2, -1).astype(np.int32))
    with torch.no_grad():
        want = build_model(ref_cfg, "cpu", seed=0).eval()(x, loader_mask=mask)
        card = build_model(cfg, dev, seed=0).eval()
        fl.flash_mha_fwd.launches = fl.flash_f32_fwd.launches = 0
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = card(x.to(dev).bfloat16(), loader_mask=mask.to(dev))
    torch.cuda.synchronize()
    fuse = [name for name, _ in card.encoder.named_children() if name.startswith("fuse_inter_")]
    pred, pred_want = got[0][0].float().cpu(), want[0][0]
    rel = float((pred - pred_want).abs().max() / pred_want.abs().max())
    sched = k4_schedule(card.encoder, False, 0, backward=False)
    launches, want_launches = (fl.flash_mha_fwd.launches, fl.flash_f32_fwd.launches), (
        sched["flash_mha_fwd"], sched["flash_f32_fwd"])
    print(f"[small] MaskMViT-S with RESPATH_FUSE concat_linear_ln at depth {cfg.MASK.PRETRAIN_DEPTH} ({fuse}, "
          f"widths {card.encoder.intermediate_dims}; {sum(p.numel() for p in card.parameters())} params): "
          f"{tuple(x.shape)} -> predictions {tuple(pred.shape)} {got[0][0].dtype} (bf16 on the card): max rel err "
          f"vs CPU float32 {rel} (bound 5e-2); K4 forward launches {launches}, by k4_schedule {want_launches}")
    check(fuse and tuple(pred.shape) == tuple(pred_want.shape), "MaskMViT-S fuse_inter: no fusion or wrong shape")
    check(math.isfinite(rel) and rel <= 5e-2, "the card's MaskMViT-S through fuse_inter disagrees with the CPU")
    check(launches == want_launches, "MaskMViT-S fuse_inter: K4 not launched once a block by its route")
    del card
    torch.cuda.empty_cache()


def timed_aug(aug, batch, gen_seed, dev):
    """RA_AUG_REPS calls of ``aug`` alone on ``batch`` after a warm-up, CUDA
    events: (median ms, peak bytes above what was allocated before)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    aug(batch, gen)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out_ms = []
    for _ in range(RA_AUG_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = aug(batch, gen)
        end.record()
        end.synchronize()
        out_ms.append(start.elapsed_time(end))
        del out
    return statistics.median(out_ms), torch.cuda.max_memory_allocated() - base


def exact_aug_parts(aug, batch, dev):
    """Where the op-exact aug's time goes on ``batch``: the RRC resize, each
    RandAugment slot, the flip, the erasing and normalize, each stage timed
    on CUDA events between synchronizations (ms)."""
    import torch

    from advise_tpu_torch.data.device_aug import normalize, resized_crop_clips

    b, k, t, h, w, c = batch.shape
    params = aug.sample(b * k, t, h, w, c, torch.Generator(device=dev).manual_seed(11))
    flat = batch.reshape(b * k, t, h, w, c)
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        parts[name] = start.elapsed_time(end)
        return out

    clips = timed("rrc", lambda: torch.clamp(resized_crop_clips(flat.float(), params["box"], aug.size), 0, 255))
    plan = params["plan"]
    slot = copy.copy(aug.ra)
    slot.n = 1
    for i in range(aug.ra.n):
        one = {key: v[:, i:i + 1] for key, v in plan.items()}
        clips = timed(f"slot {i} ops {sorted(set(one['sel'][:, 0].tolist()))}", lambda: slot.apply(clips, one))
    flip = params["flip"].view(-1, 1, 1, 1, 1)
    clips = timed("flip", lambda: torch.where(flip, clips.flip(3), clips))
    clips = timed("erasing", lambda: aug.erasing.apply(clips, params["erase"]))
    timed("normalize", lambda: normalize(clips, aug.mean, aug.std, by_reciprocal=True).to(aug.out_dtype))
    return parts


def ra_exact_path(tconfig, dev, byol_ms, byol_peak) -> dict:
    """Phase 7h, path (a): the BYOL preset with AUG.FUSED_RA False at full
    width. First the op-exact aug alone on the step's batch (16 videos x 2
    views x 32 frames at 298x224 -> 224^2, bicubic) against the fused aug
    alone, in this call: median ms, the peak above the batch, and where the
    op-exact aug's time goes; then CON_WARMUP + CON_TIMED steps and one
    profiled step: median ms and peak against phase 5's batched step,
    finite losses, K1/K2 (2, 1) a step. Returns its K1/K2 launches."""
    import torch

    from advise_tpu_torch.data import build_device_aug
    from advise_tpu_torch.tools.compare_steps import step_run, time_steps

    cfg = one_card_cfg(tconfig, BYOL_CONFIG, RA_EXACT)
    run = step_run(cfg, dev, 13, EPOCH_EXACT)
    fused = build_device_aug(one_card_cfg(tconfig, BYOL_CONFIG), "train")
    exact_ms, exact_peak = timed_aug(run.aug, run.clips, 1, dev)
    fused_ms, fused_peak = timed_aug(fused, run.clips, 1, dev)
    parts = exact_aug_parts(run.aug, run.clips, dev)
    print(f"[7h] the op-exact 'aa' aug alone on {tuple(run.clips.shape)} uint8 ({cfg.AUG.AA_TYPE}, "
          f"{run.aug.ra.method}, RE_PROB {cfg.AUG.RE_PROB}): {exact_ms} ms, peak {exact_peak} bytes above the "
          f"batch; the fused aug alone {fused_ms} ms, peak {fused_peak} bytes; {exact_ms / fused_ms} of its time, "
          f"{exact_peak / fused_peak} of its peak")
    print(f"[7h] the op-exact aug by stage (ms, one call): {parts}")

    def after_step(i, vals, ms):
        print(f"[7h] FUSED_RA False BYOL step {i}: {vals} ({ms} ms)")
        check(all(math.isfinite(v) for v in vals.values()), f"FUSED_RA False step {i} is not finite")

    n_steps = CON_WARMUP + CON_TIMED
    with bn_on_kernels("FUSED_RA False BYOL", n_steps, *run_models(run)):
        median_ms, step_ms, peak, launches = time_steps(run, CON_WARMUP, CON_TIMED, counted_kernels(),
                                                        after_step=after_step)
    got = (launches["stem_conv_fwd"], launches["stem_conv_wgrad"])
    print(f"[7h] FUSED_RA False BYOL step: median {median_ms} ms over {CON_TIMED} steps (all: {step_ms}), peak "
          f"allocated {peak} bytes; the batched BYOL step of phase 5 (this call): {byol_ms} ms, {byol_peak} "
          f"bytes ({median_ms / byol_ms} of its time, {peak / byol_peak} of its peak); launches {launches}")
    check(got == (2 * n_steps, n_steps), "FUSED_RA False: K1/K2 launches differ from (2, 1) a step")
    check(launches["fused_simple_aug"] == 0 and launches["flash_mha_fwd"] == 0, "FUSED_RA False: a kernel off "
          "the path was launched")
    profile_step("FUSED_RA False BYOL", run.call, "7h")
    del run, fused
    gc.collect()
    torch.cuda.empty_cache()
    return {"stem_conv_fwd": got[0], "stem_conv_wgrad": got[1]}


def mvit_con_path(tconfig, dev, byol_ms, byol_peak, k4_checked) -> dict:
    """Phase 7h, path (c): ContrastiveModel over the reversible MViT-S
    (MVIT_CON) on the BYOL preset's recipe at full width, CON_WARMUP +
    CON_TIMED MoCo steps and one profiled step: median ms, peak, finite
    losses, moving parameters, K4's forward and backward launches equal
    to ``k4_schedule`` (the online forward and backward, the momentum
    encoder's keys), and every attention shape the steps gave K4 among
    ``k4_checked`` (phase 3's). Returns its K4 launches."""
    import torch

    from advise_tpu_torch.models.layers import attention
    from advise_tpu_torch.tools.compare_steps import step_run, time_steps

    cfg = mvit_con_cfg(tconfig)
    run = step_run(cfg, dev, 14, EPOCH_EXACT)
    model = run.state.model
    sched = k4_schedule(model.backbone, bool(cfg.TPU.REMAT), 1)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[7h] ContrastiveModel over MViT-S ({n_params} params; plan {model.backbone.plan}; head dims "
          f"{head_dims(model.backbone)}; REMAT {cfg.TPU.REMAT}, {cfg.CONTRASTIVE.TYPE}, "
          f"{cfg.SOLVER.OPTIMIZING_METHOD} LARS {cfg.SOLVER.LARS_ON}), clips {tuple(run.clips.shape)} uint8 -> "
          f"'aa' {cfg.AUG.TARGET_SIZE}; K4 a step by the schedule {sched}")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    def after_step(i, vals, ms):
        print(f"[7h] MViT-S MoCo step {i}: {vals} ({ms} ms)")
        check(all(math.isfinite(v) for v in vals.values()), f"MViT-S MoCo step {i} is not finite")

    n_steps = CON_WARMUP + CON_TIMED
    seen, flash_mha = set(), attention.flash_mha

    def recorded(q, k, v, scale):
        seen.add((*q.shape[:3], k.shape[2], q.shape[3]))
        return flash_mha(q, k, v, scale)

    attention.flash_mha = recorded
    try:
        with bn_on_kernels("MViT-S MoCo", CON_WARMUP + CON_TIMED, *run_models(run)):
            median_ms, step_ms, peak, launches = time_steps(run, CON_WARMUP, CON_TIMED, counted_kernels(),
                                                            after_step=after_step)
    finally:
        attention.flash_mha = flash_mha
    print(f"[7h] MViT-S MoCo: K4's attention shapes {sorted(seen)}, phase 3 checked each: {seen <= k4_checked}")
    check(seen <= k4_checked, f"MViT-S MoCo: K4 ran at shapes phase 3 did not check: {seen - k4_checked}")
    moved = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    got = {name: launches[name] for name in sched}
    want = {name: n * n_steps for name, n in sched.items()}
    print(f"[7h] MViT-S MoCo step: median {median_ms} ms over {CON_TIMED} steps (all: {step_ms}), "
          f"{2 * cfg.DATA.BATCHSIZE_PER_GPU * 1e3 / median_ms} clip-views/s, peak allocated {peak} bytes "
          f"({peak / byol_peak} of phase 5's BYOL step; its time {byol_ms} ms); K4 launches {got} (schedule "
          f"{want}), launches {launches}; {moved} of {len(before)} parameters moved")
    check(got == want, "MViT-S MoCo: K4 launches differ from the schedule")
    check(launches["stem_conv_fwd"] == launches["fused_simple_aug"] == 0,
          "MViT-S MoCo: a kernel off the path was launched")
    check(moved > 0 and all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          "MViT-S MoCo: the parameters did not move or are not finite")
    profile_step("MViT-S MoCo", run.call, "7h")
    del run, model, before
    gc.collect()
    torch.cuda.empty_cache()
    return got


def resumed_pair(label, config, run_dir, overrides, first_extra, second_extra, iters, epochs, start_epoch=0,
                 between=None):
    """An entry-point run of ``epochs`` epochs from ``start_epoch`` and its
    resume (TRAIN.AUTO_RESUME) for one more: both records, after checking
    the schedule, finite stats and that the resumed run starts from the
    saved model (and SSL state) bit for bit by sha256. ``between(r1)`` runs
    after the first run."""
    import shutil

    shutil.rmtree(run_dir, ignore_errors=True)
    r1 = run_entry_point(first_extra, f"{label}, {epochs} epoch(s)", config, run_dir, overrides)
    if between is not None:
        between(r1)
    r2 = run_entry_point(second_extra + ["TRAIN.AUTO_RESUME", "True"], f"{label}, resume", config, run_dir,
                         overrides)
    for rec, run, n in ((r1, "first run", epochs * iters), (r2, "resumed run", iters)):
        split = {stage: f"{s * 1e3 / c} ms x {c} ({s * 1e3} ms in all)" for stage, (s, c) in rec["host_s"].items()}
        print(f"[run] {label} {run}: start epoch {rec['start_epoch']} step {rec['start_step']}, stats "
              f"{rec['stats']}, iterations {[t * 1e3 for t in rec['iter_s']]} ms, loader wait "
              f"{[t * 1e3 for t in rec['wait_s']]} ms, peak allocated {rec['peak_allocated_bytes']} bytes, "
              f"launches {rec['launches']}, {rec['seconds']} s with start-up; host stages {split}")
        check(len(rec["iter_s"]) == n, f"{label} {run}: wrong schedule")
        check(all(math.isfinite(v) for st in rec["stats"] for v in st.values()), f"{label} {run}: not finite")
    print(f"[run] {label}: model sha256 end of the first run {r1['model_sha256_end']}, start of the resumed run "
          f"{r2['model_sha256']}; SSL sha256 {r1.get('ssl_sha256_end')} / {r2.get('ssl_sha256')}")
    check(r1["start_step"] == 0 and r2["start_epoch"] == start_epoch + epochs and r2["start_step"] == epochs * iters,
          f"{label}: wrong start or resume point")
    check(r1["model_sha256_end"] == r2["model_sha256"], f"the resumed {label} model differs from the saved one")
    check(r1.get("ssl_sha256_end") == r2.get("ssl_sha256"), f"the resumed {label} SSL state differs")
    return r1, r2


def host_aug_entries(tconfig) -> None:
    """Phase 8, path (b): SpeedPro_R50.yaml with TPU.DEVICE_AUG False
    through the entry point, one epoch of 16 synthetic videos with a
    profiler window over its second iteration, then a resume to 2 (bit for
    bit); the host aug's seconds in the run record's host stages; no K3
    launch (TPU.PALLAS_AUG stays on in the preset, as in JAX it launches
    nothing without the device aug). Then one iteration of X3D_M_K400.yaml
    the same way."""
    import shutil

    scfg = one_card_cfg(tconfig, SPEED_CONFIG, {"TPU.DEVICE_AUG": False})
    iters = SPEED_RUN_VIDEOS // scfg.DATA.BATCHSIZE_PER_GPU
    r1, r2 = resumed_pair("SpeedPro host aug", SPEED_CONFIG, HOST_AUG_RUN_DIR, HOST_AUG_OVERRIDES,
                          ["SOLVER.MAX_EPOCH", "1", "TPU.PROFILE_DIR", f"{HOST_AUG_RUN_DIR}/profile",
                           "TPU.PROFILE_START", "0", "TPU.PROFILE_STEPS", "1"], ["SOLVER.MAX_EPOCH", "2"], iters, 1)
    for rec in (r1, r2):
        check(rec["launches"]["fused_simple_aug"] == 0, "SpeedPro host aug: K3 was launched")
        check(rec["host_s"].get("host_aug", (0, 0))[1] == iters * scfg.DATA.BATCHSIZE_PER_GPU,
              "SpeedPro host aug: the host aug did not run once an item")
    prof = r1.get("profile")
    check(prof is not None, "the host-aug run's profile window did not close")
    (aug_s, n_aug), (item_s, n_item) = r1["host_s"]["host_aug"], r1["host_s"]["item"]
    print(f"[run] SpeedPro host aug profile window ({prof['steps']} iteration): wall {prof['wall_ms']} ms, device "
          f"busy {prof['busy_ms']} ms, idle share {prof['idle_share']}; the host aug {aug_s * 1e3 / n_aug} ms an "
          f"item, {aug_s / item_s} of a worker's item time ({item_s * 1e3 / n_item} ms an item), "
          f"{scfg.DATA.WORKERS} workers")
    xcfg = one_card_cfg(tconfig, X3D_CONFIG, {"TPU.DEVICE_AUG": False})
    shutil.rmtree(X3D_HOST_AUG_RUN_DIR, ignore_errors=True)
    x3d = run_entry_point(["TPU.DEVICE_AUG", "False", "DATA.SYNTHETIC_SIZE", str(xcfg.DATA.BATCHSIZE_PER_GPU)],
                          "X3D-M host aug, 1 iteration", X3D_CONFIG, X3D_HOST_AUG_RUN_DIR, X3D_RUN_OVERRIDES)
    split = {stage: f"{s * 1e3 / c} ms x {c} ({s * 1e3} ms in all)" for stage, (s, c) in x3d["host_s"].items()}
    print(f"[run] X3D-M host aug: stats {x3d['stats']}, iterations {[t * 1e3 for t in x3d['iter_s']]} ms, loader "
          f"wait {[t * 1e3 for t in x3d['wait_s']]} ms, peak allocated {x3d['peak_allocated_bytes']} bytes, "
          f"launches {x3d['launches']}, {x3d['seconds']} s with start-up; host stages {split}")
    check(len(x3d["iter_s"]) == 1 and all(math.isfinite(v) for v in x3d["stats"][0].values()),
          "X3D-M host aug: wrong schedule or not finite")
    check(not any(but_bn(x3d["launches"]).values()), "X3D-M host aug: a kernel other than BN's was launched")


def mvit_entries(tconfig) -> None:
    """Phase 8, path (c) and ROADMAP A 7: ContrastiveModel over MViT
    (MVIT_CON) through the entry point, one epoch of 32 synthetic videos (2
    iterations, the kNN probe), K4 by the schedule (each probe batch's
    forward once more an attention), then a resume to 2 bit for bit (model
    and SSL state); then MViT_S_rev_masked.yaml the same way (the loader's
    block masks, HOG; no kernel: the preset runs the dense chain)."""
    ccfg = mvit_con_cfg(tconfig)
    over = MVIT_RUN_OVERRIDES + as_argv({**mvit_s_block(), **MVIT_CON})
    iters = MVIT_RUN_VIDEOS // ccfg.DATA.BATCHSIZE_PER_GPU
    probe = RUN_KNN_BATCHES if ccfg.CONTRASTIVE.KNN_ON else 0
    backbone = plan_model(ccfg).backbone
    step_sched = k4_schedule(backbone, bool(ccfg.TPU.REMAT), 1)
    # a probe batch runs under torch.no_grad(): one forward an attention
    probe_sched = k4_schedule(backbone, False, 0, backward=False)
    want = {name: n * iters + probe_sched[name] * probe for name, n in step_sched.items()}
    r1, r2 = resumed_pair("ContrastiveModel over MViT-S", BYOL_CONFIG, MVIT_CON_RUN_DIR, over,
                          ["SOLVER.MAX_EPOCH", "1"], ["SOLVER.MAX_EPOCH", "2"], iters, 1)
    for rec in (r1, r2):
        got = {name: rec["launches"][name] for name in step_sched}
        print(f"[run] ContrastiveModel over MViT-S: K4 launches {got} (schedule {want}: {iters} steps and "
              f"{probe} probe batch)")
        check(got == want, "ContrastiveModel over MViT-S: K4 launches differ from the schedule")
    scfg = one_card_cfg(tconfig, MVIT_S_CONFIG)
    s_iters = MVIT_RUN_VIDEOS // scfg.DATA.BATCHSIZE_PER_GPU
    m1, m2 = resumed_pair("MViT_S_rev_masked.yaml", MVIT_S_CONFIG, MVIT_S_RUN_DIR, MVIT_RUN_OVERRIDES,
                          ["SOLVER.MAX_EPOCH", "1"], ["SOLVER.MAX_EPOCH", "2"], s_iters, 1)
    for rec in (m1, m2):
        check(not any(but_bn(rec["launches"]).values()),
              "MViT_S_rev_masked.yaml: a kernel other than BN's was launched")


def remote_tree(url) -> dict:
    """{path relative to ``url``: bytes} of every file under a remote
    directory, through fsspec."""
    import fsspec

    fs, root = fsspec.core.url_to_fs(url)
    return {os.path.relpath(p, root): info["size"] for p, info in fs.find(root, detail=True).items()}


def local_tree(path) -> dict:
    return {os.path.relpath(os.path.join(d, f), path): os.path.getsize(os.path.join(d, f))
            for d, _, files in os.walk(path) for f in files}


def remote_entries(tconfig) -> dict:
    """Phase 8, remote storage: path (c) (MVIT_CON over the reversible
    MViT-S) with MVIT.REV.RESPATH_FUSE concat_linear_ln through the entry
    point, its videos in a local:// store (DATA.DATADIR; the split file
    stays local) and TRAIN.CHECKPOINT_REMOTE a local:// mirror. One epoch
    (every video fetched once into the media cache; the mirror exactly the
    local tree); then the local checkpoints and the media cache removed, and
    a resume to 2 that comes from the mirror: the model and SSL state bit
    for bit (``resumed_pair``), the best criteria as saved, no nested
    directory in the mirror; K4 by the schedule in both runs. Returns the
    two runs' K4 launches."""
    import hashlib
    import shutil
    import tempfile

    import numpy as np

    from advise_tpu_torch.data import ingest_geometry
    from advise_tpu_torch.utils import storage

    root = os.path.abspath(REMOTE_ROOT)
    shutil.rmtree(root, ignore_errors=True)
    videos, mirror, labels = f"local://{root}/videos", f"local://{root}/mirror", os.path.join(root, "labels")
    os.makedirs(labels)
    ccfg = mvit_con_cfg(tconfig)
    w, h = ingest_geometry(ccfg, "train")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(REMOTE_VIDEOS):
        with storage.smart_open(f"{videos}/v{i:03d}.npy", "wb") as f:
            np.save(f, rng.integers(0, 256, (REMOTE_FRAMES, h, w, 3), dtype=np.uint8))
    with open(os.path.join(labels, "train.csv"), "w") as f:
        f.writelines(f"v{i:03d}.npy {i % 4}\n" for i in range(REMOTE_VIDEOS))
    print(f"[remote] {REMOTE_VIDEOS} videos of [{REMOTE_FRAMES}, {h}, {w}, 3] uint8 written to {videos} in "
          f"{time.perf_counter() - t0} s")
    over = ONE_CARD + ["DATA.DECODE_BACKEND", "auto", "DATA.DATADIR", videos, "DATA.LABELDIR", labels,
                       "DATA.SPLITFILE", "train.csv", "TRAIN.SAVE_FREQ", "1", "TRAIN.CHECKPOINT_REMOTE", mirror,
                       "CONTRASTIVE.KNN_EVAL_BATCHES", str(RUN_KNN_BATCHES)]
    over += as_argv({**mvit_s_block(), **MVIT_CON, **REMOTE_FUSE})
    fcfg = one_card_cfg(tconfig, BYOL_CONFIG, {**mvit_s_block(), **MVIT_CON, **REMOTE_FUSE})
    iters = REMOTE_VIDEOS // fcfg.DATA.BATCHSIZE_PER_GPU
    probe = RUN_KNN_BATCHES if fcfg.CONTRASTIVE.KNN_ON else 0
    model = plan_model(fcfg)
    n_params = sum(p.numel() for p in model.parameters())
    fuse = model.backbone.fuse
    step_sched = k4_schedule(model.backbone, bool(fcfg.TPU.REMAT), 1)
    probe_sched = k4_schedule(model.backbone, False, 0, backward=False)
    want = {name: n * iters + probe_sched[name] * probe for name, n in step_sched.items()}
    print(f"[remote] ContrastiveModel over MViT-S with RESPATH_FUSE {fuse.mode} ({n_params} params; fuse.proj "
          f"{tuple(fuse.proj.weight.shape)}, fuse.ln {tuple(fuse.ln.weight.shape)})")
    cache = os.path.join(root, "tmp", storage.MEDIA_CACHE)
    want_cache = {hashlib.sha1(f"{videos}/v{i:03d}.npy".encode()).hexdigest() + ".npy" for i in range(REMOTE_VIDEOS)}
    ckpt_dir = os.path.join(REMOTE_RUN_DIR, "checkpoints")
    saved = {}

    def cold(r1):
        tree, local = remote_tree(mirror), local_tree(ckpt_dir)
        print(f"[remote] after one epoch: the media cache holds {len(os.listdir(cache))} files; the mirror "
              f"{sorted(tree)} ({sum(tree.values())} bytes written); the local tree {sorted(local)}")
        check(set(os.listdir(cache)) == want_cache, "remote storage: the media cache does not hold each video once")
        check(tree == local, "remote storage: the mirror is not exactly the local tree")
        with storage.smart_open(f"{mirror}/Model_Best.meta.npy", "rb") as f:
            saved["best"] = float(np.load(f, allow_pickle=True)[0]["best"])
        saved["bytes"] = sum(tree.values())
        check(saved["best"] == r1["best_end"], "remote storage: the mirror's best criteria differ from the run's")
        shutil.rmtree(ckpt_dir)
        shutil.rmtree(cache)

    tmpdir = tempfile.tempdir
    tempfile.tempdir = os.path.join(root, "tmp")  # the media cache under build/
    os.makedirs(tempfile.tempdir)
    try:
        r1, r2 = resumed_pair("remote storage, MViT-S concat_linear_ln", BYOL_CONFIG, REMOTE_RUN_DIR, over,
                              ["SOLVER.MAX_EPOCH", "1"], ["SOLVER.MAX_EPOCH", "2"], iters, 1, between=cold)
    finally:
        tempfile.tempdir = tmpdir
    tree = remote_tree(mirror)
    nested = [p for p in tree if p.count("/") > 1 or (p.count("/") == 1 and not p.endswith("/state.pt"))]
    fetched = local_tree(os.path.join(ckpt_dir, "Model_Epoch_0000"))
    print(f"[remote] after the resume: the best criteria {r2['best_start']} at its start (saved {saved['best']}), "
          f"{r2['best_end']} at its end; the media cache {len(os.listdir(cache))} files; fetched "
          f"Model_Epoch_0000 {fetched}; the mirror {sorted(tree)}, {sum(tree.values())} bytes (the first run "
          f"wrote {saved['bytes']}); nested paths {nested}")
    check(r2["best_start"] == saved["best"], "remote storage: the best criteria did not survive the cold restart")
    check(set(os.listdir(cache)) == want_cache, "remote storage: the resumed run did not fetch each video")
    check(fetched == {k[len("Model_Epoch_0000/"):]: v for k, v in tree.items() if k.startswith("Model_Epoch_0000/")},
          "remote storage: the fetched checkpoint differs from the mirror's")
    check(not nested, f"remote storage: the mirror nests {nested}")
    # the resumed epoch's new best is the mirror's second Model_Best write,
    # the one JAX's put nests
    check(r2["best_end"] < saved["best"], "remote storage: no second new best, so no second Model_Best write")
    second = {k: v for k, v in tree.items() if k.split("/")[0].split(".")[0] in ("Model_Epoch_0001", "Model_Best")}
    for name in ("Model_Epoch_0001", "Model_Best"):
        mine = {k: v for k, v in tree.items() if k.startswith(name + "/")}
        check(mine == {f"{name}/{k}": v for k, v in local_tree(os.path.join(ckpt_dir, name)).items()},
              f"remote storage: the mirror's {name} differs from the local one")
    videos_bytes = sum(remote_tree(videos).values())
    print(f"[remote] bytes written: the mirror {saved['bytes']} + {sum(second.values())}; the local checkpoints "
          f"the same plus the {fetched['state.pt']} fetched; the videos {videos_bytes} and the media cache twice that")
    total = {name: 0 for name in step_sched}
    for label, rec in (("first run", r1), ("resumed run", r2)):
        got = {name: rec["launches"][name] for name in step_sched}
        print(f"[remote] {label}: K4 launches {got} (schedule {want}: {iters} steps and {probe} probe batch)")
        check(got == want, f"remote storage ({label}): K4 launches differ from the schedule")
        total = {name: total[name] + n for name, n in got.items()}
    return total


def mvit_l_entry(tconfig) -> None:
    """Phase 9 (ROADMAP A 7): MViT_L_32x312_joint.yaml through the entry
    point at full width and depth on one card, one epoch of 2 iterations
    (a profiler window over the second) and a resume to 2, bit for bit;
    K4's forward and backward launches equal ``k4_schedule`` (REMAT, no
    forward without a gradient) in each run."""
    mcfg = one_card_cfg(tconfig, MASKED_CONFIG)
    iters = MVIT_L_RUN_VIDEOS // mcfg.DATA.BATCHSIZE_PER_GPU
    model = plan_model(mcfg)
    n_params = sum(p.numel() for p in model.parameters())
    sched = k4_schedule(model.encoder, bool(mcfg.TPU.REMAT), 0)
    r1, r2 = resumed_pair("MViT-L 32x312 joint", MASKED_CONFIG, MVIT_L_RUN_DIR, MVIT_L_RUN_OVERRIDES,
                          ["SOLVER.MAX_EPOCH", "1", "TPU.PROFILE_DIR", f"{MVIT_L_RUN_DIR}/profile",
                           "TPU.PROFILE_START", "0", "TPU.PROFILE_STEPS", "1"],
                          ["SOLVER.MAX_EPOCH", "2"] + NO_SAVE, iters, 1)
    want = {name: n * iters for name, n in sched.items()}
    for label, rec in (("first run", r1), ("resumed run", r2)):
        got = {name: rec["launches"][name] for name in sched}
        print(f"[run] MViT-L {label}: {n_params} params, iterations {[t * 1e3 for t in rec['iter_s']]} ms, "
              f"loader wait {[t * 1e3 for t in rec['wait_s']]} ms, peak allocated {rec['peak_allocated_bytes']} "
              f"bytes, K4 launches {got} (schedule {want}: {iters} steps)")
        check(got == want, f"MViT-L {label}: K4 launches differ from the schedule")
    check(n_params == 260_815_160, f"MViT-L has {n_params} params, not the preset's 260,815,160")
    prof = r1.get("profile")
    check(prof is not None, "the MViT-L run's profile window did not close")
    print(f"[run] MViT-L profile window ({prof['steps']} iteration): wall {prof['wall_ms']} ms, device busy "
          f"{prof['busy_ms']} ms, idle share {prof['idle_share']}")


def torchrun(argv, label, log_path, env=None, timeout=DP_TIMEOUT_S) -> int:
    """``python -m torch.distributed.run --standalone`` with ``argv`` from the
    checkout's root, its output into ``log_path``; returns its exit code.
    The job runs in a session of its own: on a timeout every process of it
    is killed and the phase fails."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", *argv]
    print(f"[dp] {label}: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
                                env={**os.environ, **(env or {})})
        try:
            code = proc.wait(timeout=timeout)
        except BaseException:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise
    print(f"[dp]   exit {code} after {time.perf_counter() - t0} s (log {log_path})")
    return code


def rank_records(run_dir, ranks):
    """Each rank's run record (``tools.run`` writes one a rank in a world of
    more than one)."""
    records = []
    for r in range(ranks):
        with open(f"{run_dir}/run_record.rank{r}.json") as f:
            records.append(json.load(f))
    return records


def nccl_shared_card_rank() -> None:
    """One of two ranks on the one card with the NCCL backend (launched with
    ``--nccl-shared-card``): an all-reduce, and what NCCL answered, into
    ``DP_RUN_DIR/nccl_rank{r}.json``."""
    import os

    import torch
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl")
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out["result"] = f"ran: all-reduce gave {x.tolist()}"
    except Exception as err:  # the finding to record: NCCL's answer
        out["result"] = f"refused: {type(err).__name__}: {str(err).splitlines()[0] if str(err) else ''}"
    with open(f"{DP_RUN_DIR}/nccl_rank{rank}.json", "w") as f:
        json.dump(out, f)
    os._exit(0)  # a communicator that failed to form can hang its teardown


def syncbn_rank() -> None:
    """Phase 10 (ii), one of two gloo ranks on the card (launched with
    ``--syncbn-check``): the BYOL preset's model (seed 0, the same on both
    ranks), this rank's 16 synthetic clips through the 'aa' aug and the
    model's eval forward of view 0, the input of the fast pathway's first BN
    (after the stem kernel K1) captured; that BN in train mode, synced over
    the 2 ranks, against one BN over both ranks' rows gathered, forward and
    the input's gradient of sum(y * g) (g drawn per rank); then
    all_gather_cat's gradient: sum(gathered * w), w the same on both ranks,
    must give each rank 2 w of its own rows exactly. Writes
    ``DP_RUN_DIR/syncbn_rank{r}.json``."""
    import copy

    import torch

    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.data import build_device_aug, build_loader
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.ops import batch_norm as bnk
    from advise_tpu_torch.parallel.collectives import all_gather_cat, world_size
    from advise_tpu_torch.parallel.mesh import distributed_init, world

    cfg = tconfig.get_cfg()
    cfg.merge_from_file(BYOL_CONFIG)
    cfg.DATA.DECODE_BACKEND = "synthetic"
    cfg.DATA.SYNTHETIC_SIZE = DP_RUN_VIDEOS
    cfg = tconfig.assert_and_infer_cfg(cfg)
    dev = distributed_init(cfg, "cuda")
    rank, n = world()
    model = build_model(cfg, dev, seed=cfg.TRAIN.SEED)
    batches = build_loader(cfg, "train").epoch(0)
    clips_u8, _ = next(batches)
    batches.close()
    gen = torch.Generator(device=dev).manual_seed(rank)
    seen = {}
    stem = model.backbone.s1_fast
    hook = stem.bn.register_forward_pre_hook(lambda m, args: seen.setdefault("x", args[0].detach()))
    model.eval()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        clips = build_device_aug(cfg, "train")(torch.from_numpy(clips_u8).to(dev), gen).to(torch.bfloat16)
        model(clips[:, 0])
    hook.remove()
    bn = stem.bn.train()
    x = seen["x"].clone().requires_grad_(True)
    g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(7 + rank), device=dev).to(x.dtype)
    for fn in bnk.COUNTED:
        fn.launches = 0
    y = bn(x)
    (y.float() * g.float()).sum().backward()
    bn_launches = {fn.__name__: fn.launches for fn in bnk.COUNTED}
    bn.pending = []
    ref = copy.deepcopy(bn)
    ref.sync_axes = ()
    x_all = all_gather_cat(x.detach()).clone().requires_grad_(True)
    y_all = ref(x_all)
    (y_all.float() * all_gather_cat(g).float()).sum().backward()
    rows = slice(rank * x.shape[0], (rank + 1) * x.shape[0])
    y_ref, dx_ref = y_all[rows].detach().float(), x_all.grad[rows].float()
    y_err = float((y.detach().float() - y_ref).abs().max() / y_ref.abs().max())
    dx_err = float((x.grad.float() - dx_ref).abs().max() / dx_ref.abs().max())
    v = x.detach()[:, :1].float().contiguous().requires_grad_(True)
    w = torch.randn((n * v.shape[0], *v.shape[1:]), generator=torch.Generator(device=dev).manual_seed(11),
                    device=dev)
    (all_gather_cat(v) * w).sum().backward()
    exact = bool(torch.equal(v.grad, world_size() * w[rows]))
    with open(f"{DP_RUN_DIR}/syncbn_rank{rank}.json", "w") as f:
        json.dump({"rank": rank, "world": n, "shape": list(x.shape), "dtype": str(x.dtype),
                   "sync_axes": list(stem.bn.sync_axes), "y_err": y_err, "dx_err": dx_err,
                   "gather_grad_exact": exact, "bn_launches": bn_launches}, f)


def dp_entries(tconfig) -> None:
    """Phase 10: data parallel on the BYOL preset at full width, 16 clips a
    rank (module constants above): NCCL with two ranks on the one card
    (what it answers, recorded), then (i), (ii) and (iii)."""
    import shutil
    from pathlib import Path

    bcfg = tconfig.get_cfg()
    bcfg.merge_from_file(BYOL_CONFIG)
    b = bcfg.DATA.BATCHSIZE_PER_GPU
    shutil.rmtree(DP_RUN_DIR, ignore_errors=True)
    Path(DP_RUN_DIR).mkdir(parents=True)
    t0 = time.perf_counter()
    torchrun(["--nproc_per_node", str(DP_RANKS), "chip_smoke.py", "--nccl-shared-card"],
             "NCCL, two ranks on one card", f"{DP_RUN_DIR}/nccl.log", timeout=180)
    for r in range(DP_RANKS):
        path = Path(DP_RUN_DIR) / f"nccl_rank{r}.json"
        print(f"[dp] NCCL with two ranks on the one card, rank {r}: "
              f"{json.loads(path.read_text())['result'] if path.is_file() else 'no answer (killed)'}")

    # (i) two gloo ranks through the entry point, then the resume
    entry = ["--nproc_per_node", str(DP_RANKS), "-m", "advise_tpu_torch.tools.run", "--cfg", BYOL_CONFIG,
             "--output", f"{DP_RUN_DIR}/run"] + DP_OVERRIDES
    iters = DP_RUN_VIDEOS // (b * DP_RANKS)
    runs = []
    for label, extra, epochs in (("1 epoch", ["SOLVER.MAX_EPOCH", "1"], 1),
                                 ("resume to 2", ["SOLVER.MAX_EPOCH", "2", "TRAIN.AUTO_RESUME", "True"] + NO_SAVE, 1)):
        code = torchrun(entry + extra, f"(i) {DP_RANKS} gloo ranks, {label}", f"{DP_RUN_DIR}/run_{len(runs)}.log")
        check(code == 0, f"data parallel (i), {label}: torchrun exited {code}")
        recs = rank_records(f"{DP_RUN_DIR}/run", DP_RANKS)
        runs.append(recs)
        for rec in recs:
            got = (rec["launches"]["stem_conv_fwd"], rec["launches"]["stem_conv_wgrad"])
            want = (2 * iters + epochs * RUN_KNN_BATCHES, iters)
            split = {st: f"{sec * 1e3 / c} ms x {c}" for st, (sec, c) in rec["host_s"].items()}
            print(f"[dp] (i) {label}, rank {rec['rank']} of {rec['world']} on {rec['device']}: start epoch "
                  f"{rec['start_epoch']} step {rec['start_step']}, stats {rec['stats']}, iterations "
                  f"{[t * 1e3 for t in rec['iter_s']]} ms, loader wait {[t * 1e3 for t in rec['wait_s']]} ms, "
                  f"peak allocated {rec['peak_allocated_bytes']} bytes, K1/K2 {got} (expected {want}); model "
                  f"sha256 {rec['model_sha256']} -> {rec['model_sha256_end']}, SSL {rec['ssl_sha256_end']}; host "
                  f"stages {split}")
            check(rec["world"] == DP_RANKS and len(rec["iter_s"]) == iters, f"(i) {label}: wrong schedule")
            check(all(math.isfinite(v) for st in rec["stats"] for v in st.values()), f"(i) {label}: not finite")
            check(got == want, f"(i) {label}: K1/K2 launches differ from (2, 1) a step and the probe's forward")
        for key in ("model_sha256", "ssl_sha256", "model_sha256_end", "ssl_sha256_end"):
            check(len({rec[key] for rec in recs}) == 1, f"(i) {label}: the ranks' {key} differ")
        check(recs[0]["stats"] == recs[1]["stats"], f"(i) {label}: the ranks' averaged stats differ")
    (first, _), (resumed, _) = runs
    print(f"[dp] (i) resume: end of the first run {first['model_sha256_end']} / {first['ssl_sha256_end']}, "
          f"start of the resumed run {resumed['model_sha256']} / {resumed['ssl_sha256']}")
    check((resumed["start_epoch"], resumed["start_step"]) == (1, iters), "(i): wrong resume point")
    check(resumed["model_sha256"] == first["model_sha256_end"] and resumed["ssl_sha256"] == first["ssl_sha256_end"],
          "(i): the resumed state differs from the saved one")

    # (ii) SyncBN and all_gather_cat across the two ranks
    code = torchrun(["--nproc_per_node", str(DP_RANKS), "chip_smoke.py", "--syncbn-check"],
                    "(ii) SyncBN across the ranks", f"{DP_RUN_DIR}/syncbn.log")
    check(code == 0, f"data parallel (ii): torchrun exited {code}")
    for r in range(DP_RANKS):
        res = json.loads((Path(DP_RUN_DIR) / f"syncbn_rank{r}.json").read_text())
        print(f"[dp] (ii) rank {r}: the fast pathway's first BN input {res['shape']} {res['dtype']}, synced over "
              f"{res['sync_axes']} of {res['world']} ranks, against one BN over both ranks' rows: output "
              f"{res['y_err']} of its largest value (bound {SYNCBN_Y_BOUND}), input gradient {res['dx_err']} (bound "
              f"{SYNCBN_DX_BOUND}); all_gather_cat's gradient exactly 2 w: {res['gather_grad_exact']}; the synced "
              f"BN's kernels {res['bn_launches']}")
        check(res["sync_axes"] == ["sync"] and res["world"] == DP_RANKS, "(ii): the BN was not synced over the ranks")
        check(res["y_err"] <= SYNCBN_Y_BOUND and res["dx_err"] <= SYNCBN_DX_BOUND, "(ii): SyncBN off its bound")
        check(res["gather_grad_exact"], "(ii): all_gather_cat's gradient is not the ranks' sum")
        # g is drawn in NCDHW, so the gradient reaching the BN takes one layout copy
        check(res["bn_launches"] == {"bn_stats": 1, "bn_apply": 1, "bn_grad_stats": 1, "bn_dx": 1,
                                     "channels_last": 1}, "(ii): the synced BN did not run on its kernels")

    # (iii) one NCCL rank against the single-process run, both at lr 0
    single = DP_OVERRIDES[:3] + [str(DP_SINGLE_VIDEOS)] + DP_OVERRIDES[4:] + DP_LR0 + ["SOLVER.MAX_EPOCH", "1"] + NO_SAVE
    alone = run_entry_point(single, "(iii) single process, lr 0", BYOL_CONFIG, f"{DP_RUN_DIR}/alone", [])
    code = torchrun(["--nproc_per_node", "1", "-m", "advise_tpu_torch.tools.run", "--cfg", BYOL_CONFIG,
                     "--output", f"{DP_RUN_DIR}/nccl_one"] + single, "(iii) one NCCL rank, lr 0",
                    f"{DP_RUN_DIR}/nccl_one.log")
    check(code == 0, f"data parallel (iii): torchrun exited {code}")
    log = Path(f"{DP_RUN_DIR}/nccl_one/log.txt").read_text()
    one = json.loads(log.split("run record: ", 1)[1].splitlines()[0])
    backend = [line for line in log.splitlines() if "process groups:" in line]
    print(f"[dp] (iii) {backend[0].split(': ', 1)[1] if backend else 'no process group line'}")
    for label, rec in (("single process", alone), ("one NCCL rank", one)):
        print(f"[dp] (iii) {label}: losses {[st['loss_byol'] for st in rec['stats']]}, grad norms "
              f"{[st['grad_norm'] for st in rec['stats']]}, model sha256 {rec['model_sha256']} -> "
              f"{rec['model_sha256_end']}, SSL {rec['ssl_sha256']} -> {rec['ssl_sha256_end']}, launches "
              f"{(rec['launches']['stem_conv_fwd'], rec['launches']['stem_conv_wgrad'])}")
    check(backend and "nccl backend" in backend[0], "(iii): the rank did not run under NCCL")
    for key in ("model_sha256", "ssl_sha256", "model_sha256_end", "ssl_sha256_end"):
        check(alone[key] == one[key], f"(iii): {key} differs from the single-process run")
    check([st["loss_byol"] for st in alone["stats"]] == [st["loss_byol"] for st in one["stats"]],
          "(iii): the losses differ from the single-process run")
    check(alone["launches"] == one["launches"], "(iii): the launches differ from the single-process run")
    print(f"[dp] phase 10 {time.perf_counter() - t0} s")


def mp_model(cfg, init, dev):
    """``cfg``'s model on ``dev`` holding ``init`` (a state_dict), laid out
    as ``build_model`` lays it (channels-last 3-D conv weights)."""
    import torch

    from advise_tpu_torch.models import MODEL_REGISTRY, compute_dtype
    from advise_tpu_torch.models.layers.norm import get_norm

    model = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME](cfg, get_norm(cfg), compute_dtype(cfg))
    model.load_state_dict(init)
    model = model.to(dev)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.dim() == 5:
                t.data = t.data.contiguous(memory_format=torch.channels_last_3d)
    return model


def mp_run(cfg, init, dev, clips, infos, steps, sched=None):
    """``steps`` train steps of ``cfg`` (its layout's groups made) from
    ``init`` on this rank's ``clips`` and ``infos``: each step's stats and
    ms, the peak allocated bytes, K4's launches and the attention shapes it
    ran at, the parameter and moment bytes this rank stores, and the whole
    state's digest."""
    import torch

    from advise_tpu_torch.engine.checkpoint import module_state, tensors_digest
    from advise_tpu_torch.models.layers import attention
    from advise_tpu_torch.engine.state import TrainState
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.engine.train import rank_keys, seeded_generator
    from advise_tpu_torch.ops import flash_attention as fl
    from advise_tpu_torch.parallel.auto_shard import describe_sharding, shard_train_state
    from advise_tpu_torch.parallel.mesh import batch_device_count, init_groups, is_auto, world
    from advise_tpu_torch.solver.optimizer import build_tx

    init_groups(cfg)
    cfg.NUM_WORLDS = batch_device_count(cfg, world()[1])
    model = mp_model(cfg, init, dev)
    named = dict(model.named_parameters())
    bundle = build_tx(cfg, named)
    state = TrainState(model, bundle.tx.init(named), 0)
    counts = None
    if is_auto(cfg):
        counts = describe_sharding(shard_train_state(cfg, state, bundle))[0]
    step = make_train_step(cfg, bundle, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (fl.flash_mha_fwd, fl.flash_mha_bwd, fl.flash_f32_fwd, fl.flash_f32_bwd):
        fn.launches = 0
    stats, ms = [], []
    seen, flash_mha = set(), attention.flash_mha

    def recorded(q, k, v, scale):
        seen.add((*q.shape[:3], k.shape[2], q.shape[3]))
        return flash_mha(q, k, v, scale)

    attention.flash_mha = recorded
    try:
        for i in range(steps):
            gen = seeded_generator(dev, cfg.TRAIN.SEED, 0, i, *rank_keys())
            t0 = time.perf_counter()
            out = step(state, clips, infos, gen, MP_LR)
            stats.append({k: float(v) for k, v in out.items()})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        attention.flash_mha = flash_mha
    launches = {fn.__name__: fn.launches for fn in (fl.flash_mha_fwd, fl.flash_mha_bwd, fl.flash_f32_fwd,
                                                    fl.flash_f32_bwd)}
    stored = sum(p.numel() * p.element_size() for p in model.parameters())
    moments = sum(t.numel() * t.element_size() for v in state.opt_state.values() if isinstance(v, dict)
                  for t in v.values())
    digest = tensors_digest(module_state(model))
    peak = torch.cuda.max_memory_allocated()
    del state, model, step, bundle, named
    gc.collect()
    torch.cuda.empty_cache()
    return {"stats": stats, "ms": ms, "peak_allocated_bytes": peak, "launches": launches,
            "param_bytes": stored, "moment_bytes": moments, "digest": digest, "counts": counts,
            "schedule": sched, "k4_shapes": sorted(seen)}


def ring_alone(dev) -> dict:
    """The ring at ``RING_SHAPE`` (bf16, the token dim over the 2 ranks)
    against the dense chain on one rank, the same inputs on both: the
    largest error over the largest value, and each one's ms (CUDA events,
    the median of 5)."""
    import torch

    from advise_tpu_torch.models.layers.attention import dense_attention
    from advise_tpu_torch.parallel.collectives import replica_index
    from advise_tpu_torch.parallel.ring_attention import ring_attention

    g = torch.Generator(device=dev).manual_seed(23)
    q, k, v = (torch.randn(RING_SHAPE, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    scale = RING_SHAPE[-1] ** -0.5
    n = RING_SHAPE[2] // MP_RANKS
    rows = slice(replica_index("seq") * n, (replica_index("seq") + 1) * n)

    def timed(fn):
        out, times = None, []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return out, statistics.median(times)

    got, ring_ms = timed(lambda: ring_attention(q[:, :, rows], k[:, :, rows], v[:, :, rows], "seq", scale))
    want, dense_ms = timed(lambda: dense_attention(q, k, v, scale))
    want = want[:, :, rows].float()
    err = float((got.float() - want).abs().max() / want.abs().max())
    return {"shape": list(RING_SHAPE), "err": err, "ring_ms": ring_ms, "dense_ms": dense_ms}


def gloo_cuda_probe(dev) -> dict:
    """Which of gloo's collectives beyond all-reduce take CUDA tensors here
    (its P2P does not: ``writev ... Bad address``, and the failure closes
    the group's connections, so it is not tried)."""
    import torch
    import torch.distributed as dist

    rank, n = dist.get_rank(), dist.get_world_size()
    x = torch.full((4 * n, 3), float(rank + 1), device=dev)
    out = {}
    for name, fn in (("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(torch.empty(4, 3, device=dev), x)),
                     ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                         torch.empty(4 * n * n, 3, device=dev), x)),
                     ("all_to_all_single", lambda: dist.all_to_all_single(torch.empty_like(x), x))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ran"
        except Exception as err:  # the finding to record
            out[name] = f"refused: {type(err).__name__}: {str(err).splitlines()[0][:160] if str(err) else ''}"
    return out


def mp_rank() -> None:
    """Phase 11, one of two gloo ranks on the card (launched with
    ``--model-parallel``): the references, the four layouts and the ring
    alone (module constants above); writes ``MP_RUN_DIR/rank{r}.json``."""
    import numpy as np
    import torch

    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.data.masking import build_mask_generator
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.models.mvit import patch_grid
    from advise_tpu_torch.parallel.mesh import distributed_init, init_groups, world
    from advise_tpu_torch.parallel.pipeline import resolve_microbatches

    def layout_cfg(overrides):
        return one_card_cfg(tconfig, MASKED_CONFIG, {"NUM_GPUS": MP_RANKS, "MVIT.DROPPATH_RATE": 0.0, **overrides})

    t0 = time.perf_counter()
    base = layout_cfg({})
    dev = distributed_init(base, "cuda")
    rank, n = world()
    template = build_model(base, "cpu", seed=base.TRAIN.SEED)
    init = {k: v.detach().clone() for k, v in template.state_dict().items()}
    enc = template.encoder
    b, k, t, s = 1, 2, base.DATA.NUM_FRAMES, base.DATA.TRAIN_CROP_SIZE
    rng = np.random.default_rng(31)
    videos = rng.standard_normal((MP_RANKS, k, t, s, s, 3)).astype(np.float32)
    masks = np.stack([build_mask_generator(base)(rng) for _ in range(MP_RANKS * k)]).astype(np.int32)
    masks = masks.reshape(MP_RANKS, k, *masks.shape[1:])

    def batch(rows):
        return (torch.from_numpy(videos[rows]).to(dev), {"mask": torch.from_numpy(masks[rows]).to(dev)})

    rows = {"first": slice(0, b), "own": slice(rank * b, (rank + 1) * b), "both": slice(0, MP_RANKS * b)}

    remat = bool(base.TPU.REMAT)
    plain = k4_schedule(enc, remat, 0)
    n_micro = resolve_microbatches(int(base.TPU.PIPE_MICROBATCH or 0), b * k, 2)
    scheds = {"a": k4_schedule(enc, remat, 0, seq=2, thw=patch_grid(base)), "b": k4_schedule(enc, remat, 0, pipe=2,
                                                                                          n_micro=n_micro),
              "c": plain, "d": plain}
    del template, enc
    out = {"rank": rank, "world": n, "device": torch.cuda.get_device_name(dev), "n_micro": n_micro,
           "setup_s": time.perf_counter() - t0}
    out["references"] = {name: mp_run(layout_cfg(over), init, dev, *batch(rows[videos_of]), 1)
                         for name, (over, videos_of) in MP_REFERENCES.items()}
    for name, over in MP_LAYOUTS.items():
        cfg = layout_cfg(over)
        mine = rows["own" if cfg.TPU.FSDP else "first"]  # (d) carries the batch over 'data'; (a)-(c) replicate it
        t1 = time.perf_counter()
        out[name] = mp_run(cfg, init, dev, *batch(mine), 1 + MP_TIMED, {"per_step": scheds[name]})
        out[name]["seconds"] = time.perf_counter() - t1
        with open(f"{MP_RUN_DIR}/rank{rank}.json", "w") as f:  # what a later failure leaves
            json.dump(out, f)
    init_groups(layout_cfg(MP_LAYOUTS["a"]))
    out["ring"] = ring_alone(dev)
    out["gloo_cuda"] = gloo_cuda_probe(dev)
    out["seconds"] = time.perf_counter() - t0
    with open(f"{MP_RUN_DIR}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def mp_entries(k4_checked) -> tuple:
    """Phase 11: the torchrun of ``mp_rank`` on 2 gloo ranks, each rank's
    numbers printed beside the card, every check; K4 held against its plain
    version at each attention shape the layouts gave it that is not among
    ``k4_checked`` (phase 3's). Returns the K4 launches of the layouts'
    steps on both ranks, by kernel, and the largest error of those checks."""
    import shutil
    from pathlib import Path

    import torch

    from advise_tpu_torch.ops import flash_attention as fl

    shutil.rmtree(MP_RUN_DIR, ignore_errors=True)
    Path(MP_RUN_DIR).mkdir(parents=True)
    t0 = time.perf_counter()
    code = torchrun(["--nproc_per_node", str(MP_RANKS), "chip_smoke.py", "--model-parallel"],
                    "model-parallel layouts, 2 gloo ranks", f"{MP_RUN_DIR}/ranks.log", timeout=MP_TIMEOUT_S)
    if code != 0:
        print(Path(f"{MP_RUN_DIR}/ranks.log").read_text()[-6000:])
    check(code == 0, f"phase 11: torchrun exited {code}")
    ranks = [json.loads((Path(MP_RUN_DIR) / f"rank{r}.json").read_text()) for r in range(MP_RANKS)]
    card = card_line()
    totals, shapes = {}, set()
    for res in ranks:
        r = res["rank"]
        print(f"[mp] rank {r} of {res['world']} on {res['device']} ({card}): set-up {res['setup_s']} s, "
              f"{res['n_micro']} microbatches")
        for ref_name, ref in res["references"].items():
            print(f"[mp]   reference {ref_name}: stats {ref['stats'][0]}, {ref['ms'][0]} ms, peak "
                  f"{ref['peak_allocated_bytes']} bytes, K4 {ref['launches']}")
            shapes.update(tuple(sh) for sh in ref["k4_shapes"])
        for name in MP_LAYOUTS:
            run = res[name]
            first = run["stats"][0]
            steps = 1 + MP_TIMED
            sched = {key: v * steps for key, v in run["schedule"]["per_step"].items()}
            layout_shapes = {tuple(sh) for sh in run["k4_shapes"]}
            shapes |= layout_shapes
            print(f"[mp]   ({name}) {MP_LAYOUTS[name]}: step ms {run['ms']}, peak {run['peak_allocated_bytes']} "
                  f"bytes, parameters {run['param_bytes']} + moments {run['moment_bytes']} bytes stored, first "
                  f"step {first}; K4 {run['launches']} (schedule {sched}) at {sorted(layout_shapes)}, of which "
                  f"phase 3 did not check {sorted(layout_shapes - k4_checked)}; digest {run['digest']}; sharding "
                  f"{run['counts']}; {run['seconds']} s")
            check(all(math.isfinite(v) for st in run["stats"] for v in st.values()), f"phase 11 ({name}): not finite")
            for ref_name in MP_REFERENCE[name]:
                want = res["references"][ref_name]["stats"][0]
                loss_err = max(abs(first[key] - want[key]) / max(abs(want[key]), 1e-2)
                               for key in want if key.startswith("loss"))
                gnorm_err = abs(first["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
                print(f"[mp]   ({name}) against {ref_name} {want}: losses {loss_err} (bound {MP_LOSS_BOUND}), "
                      f"grad norm {gnorm_err} (bound {MP_GNORM_BOUND})")
                check(loss_err <= MP_LOSS_BOUND and gnorm_err <= MP_GNORM_BOUND,
                      f"phase 11 ({name}): the first step is off {ref_name}")
            check(run["launches"] == sched, f"phase 11 ({name}): K4 launches differ from the schedule")
            for key, v in run["launches"].items():
                totals[key] = totals.get(key, 0) + v
        ring = res["ring"]
        print(f"[mp]   ring alone {ring['shape']} bf16 over {MP_RANKS} ranks: error {ring['err']} of the dense "
              f"chain's largest value (bound {RING_BOUND}); ring {ring['ring_ms']} ms a rank, dense chain on one "
              f"rank {ring['dense_ms']} ms")
        check(ring["err"] <= RING_BOUND, "phase 11: the ring is off the dense chain")
        print(f"[mp]   gloo with CUDA tensors: {res['gloo_cuda']}; rank {r} {res['seconds']} s")
    for name in MP_LAYOUTS:
        check(len({res[name]["digest"] for res in ranks}) == 1, f"phase 11 ({name}): the ranks' states differ")
    # the shapes phase 3 did not check, held against the plain version here
    # (this process holds the card alone again)
    check(all(fl.route(torch.bfloat16, sh[4]) == "wgmma" for sh in shapes), "phase 11: K4's float32 pair ran")
    new = sorted(shapes - k4_checked)
    errs = {"flash_mha_fwd": 0.0, "flash_mha_bwd": 0.0}
    g = torch.Generator(device="cuda").manual_seed(29)
    for shape in new:
        got, _ = k4_against_plain(fl, shape, "cuda", g)
        errs = {key: max(errs[key], got[key]) for key in errs}
    torch.cuda.empty_cache()
    print(f"[mp] K4 at the {len(shapes)} attention shapes of phase 11: {len(new)} beyond phase 3's, each held "
          f"against its plain version above: {new}; largest errors {errs}")
    d, c = ranks[0]["d"], ranks[0]["c"]
    print(f"[mp] (d) against (c): {d['param_bytes'] + d['moment_bytes']} against "
          f"{c['param_bytes'] + c['moment_bytes']} parameter and moment bytes a rank")
    print(f"[mp] phase 11 {time.perf_counter() - t0} s")
    return totals, errs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; the port runs on a card only")

    import numpy as np

    from advise_tpu_torch import config as tconfig
    from advise_tpu_torch.data import build_device_aug, ingest_geometry
    from advise_tpu_torch.engine.contrastive import init_ssl_state
    from advise_tpu_torch.engine.state import TrainState
    from advise_tpu_torch.engine.steps import make_train_step
    from advise_tpu_torch.models import build_model
    from advise_tpu_torch.models.layers.norm import SyncBatchNorm
    from advise_tpu_torch.models.layers.resnet import ResStage
    from advise_tpu_torch.data.masking import build_mask_generator
    from advise_tpu_torch.ops import batch_norm as bnk
    from advise_tpu_torch.ops import build
    from advise_tpu_torch.ops import flash_attention as fl
    from advise_tpu_torch.ops import fused_aug as fa
    from advise_tpu_torch.ops import stem_conv as sc
    from advise_tpu_torch.ops import window_probe as wp
    from advise_tpu_torch.solver.lr_policy import get_lr_at_epoch
    from advise_tpu_torch.solver.optimizer import build_tx

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # the plain versions are the references: no TF32 anywhere in this run
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. environment ---------------------------------------------------------
    card = card_line()
    nvcc_version = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[env] card: {card}; clocks, power, temperature: {card_state()}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, {nvcc_version}, "
          f"python {sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")

    print(f"[phase] 2 starts at {time.perf_counter() - t_start} s")
    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all(verbose=True)
    for src, (path, seconds) in built.items():
        print(f"[build] {src} -> {path.name} in {seconds:.3f} s")
    print(f"[build] all sources in {time.perf_counter() - t0:.3f} s (in parallel)")

    print(f"[phase] 3 starts at {time.perf_counter() - t_start} s")
    # -- 3. kernel vs plain -----------------------------------------------------
    cfg = one_card_cfg(tconfig, BYOL_CONFIG)
    b, k, t = cfg.DATA.BATCHSIZE_PER_GPU, cfg.DATA.NUM_CLIP, cfg.DATA.NUM_FRAMES
    s = cfg.AUG.TARGET_SIZE
    kt = 5  # the fast stem's temporal kernel (SLOWFAST_TEMP_KERNELS)
    g = torch.Generator(device=dev).manual_seed(0)

    def in_turns(kernel, plain, reps=1):
        kernel()  # warm both
        plain()
        torch.cuda.synchronize()
        p, kk = times_ms(plain), times_ms(kernel, reps=reps)
        kk += times_ms(kernel, reps=reps)
        p += times_ms(plain)
        return statistics.median(kk), statistics.median(p)

    def queued_in_turns(kernel, plain, reps):
        kernel()  # warm both
        plain()
        torch.cuda.synchronize()
        p, kk = times_ms(plain), queued_ms(kernel, reps)
        kk += queued_ms(kernel, reps)
        p += times_ms(plain)
        return statistics.median(kk), statistics.median(p)

    def alone(fn, reps=1):
        fn()
        torch.cuda.synchronize()
        return statistics.median(times_ms(fn, 20, reps))

    results = {}
    # the stem kernels' registers, spills and shared memory (ptxas -v of the
    # build); K1 and K2 must not spill
    for name, use in sorted(sc.kernel_usage().items()):
        print(f"[kernel] {name}: {use['registers']} registers, spill stores {use['spill_stores']} B, "
              f"loads {use['spill_loads']} B, static shared {use['smem']} B")
        if name in ("stem_fwd_kernel", "stem_wgrad_partial_kernel"):
            check(use["spill_stores"] == use["spill_loads"] == 0, f"{name} spills registers")
    # the BYOL path runs both views as one batch: the stem sees k * b clips;
    # mem, and CONTRASTIVE.SEQUENTIAL's clip by clip, run one view: b clips
    for shape in [(k * b, t, s, s, 3), (b, t, s, s, 3), (2, 7, 37, 45, 3)]:
        x = torch.randn(shape, device=dev, generator=g).bfloat16()
        w = (torch.randn((kt, 7, 7, 3, 8), device=dev, generator=g) * 0.1).bfloat16()
        splan = sc.plan(*shape[:4], kt)
        for kname in ("fwd", "wgrad"):
            kp = splan[kname]
            print(f"[kernel] stem plan {shape} kt {kt} {kname}: tile {kp['tile']}, {kp['warps']} warps, grid "
                  f"{kp['grid']} ({kp['waves']} waves, one block an SM), {kp['items']} work items "
                  f"({kp['items_per_block']} a block), ring {kp['ring']} frames, {kp['smem']} B shared"
                  + (f", {kp['partials']} partials" if kname == "wgrad" else ""))
        y = sc.stem_conv_fwd(x, w)
        ref = sc.stem_conv_plain(x.float(), w.float())
        torch.cuda.synchronize()
        fwd_err = float((y.float() - ref).abs().max())
        top = float(ref.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)  # one bf16 ulp of the largest output
        print(f"[kernel] stem_conv_fwd {shape}: max_abs_err {fwd_err} (bound: one bf16 ulp "
              f"of max|y| {top} = {ulp})")
        check(math.isfinite(fwd_err) and fwd_err <= ulp, f"stem_conv_fwd disagrees at {shape}")

        gy = torch.randn(y.shape, device=dev, generator=g).bfloat16()
        del ref
        dw = sc.stem_conv_wgrad(x, gy, kt)
        dref = sc.stem_wgrad_plain(x, gy, kt)
        torch.cuda.synchronize()
        wg_err = float((dw - dref).abs().max())
        wg_top = float(dref.abs().max())
        print(f"[kernel] stem_conv_wgrad {shape}: max_abs_err {wg_err} "
              f"(bound: 1e-3 * max|dW| {wg_top} = {1e-3 * wg_top})")
        check(math.isfinite(wg_err) and wg_err <= 1e-3 * wg_top,
              f"stem_conv_wgrad disagrees at {shape}")
        check(torch.equal(dw, sc.stem_conv_wgrad(x, gy, kt)), "stem_conv_wgrad is not deterministic")
        if shape[0] == k * b:
            fwd_ms, fwd_plain_ms = in_turns(lambda: sc.stem_conv_fwd(x, w),
                                            lambda: sc.stem_conv_plain(x, w))
            wg_ms, wg_plain_ms = in_turns(lambda: sc.stem_conv_wgrad(x, gy, kt),
                                          lambda: sc.stem_wgrad_plain(x, gy, kt))
            # the library call for the weight gradient in the kernel's input
            # type: cuDNN's bf16 conv3d_weight (bf16 out); for the forward it
            # is the plain version itself, cuDNN's bf16 conv3d
            x_ncdhw, g_ncdhw = x.permute(0, 4, 1, 2, 3), gy.permute(0, 4, 1, 2, 3)
            wg_lib_ms = alone(lambda: torch.nn.grad.conv3d_weight(
                x_ncdhw, (8, 3, kt, 7, 7), g_ncdhw, stride=(1, 2, 2), padding=(kt // 2, 3, 3)))
            flops = 2.0 * kt * 7 * 7 * 3 * 8 * y.numel() / 8
            fwd_bound = bound(2.0 * (x.numel() + w.numel() + y.numel()), flops, "bf16")
            wg_bound = bound(2.0 * (x.numel() + gy.numel()) + 4.0 * dw.numel(), flops, "bf16")
            print(f"[kernel] stem_conv_fwd {shape}: {fwd_ms} ms, plain (cuDNN bf16 conv3d) "
                  f"{fwd_plain_ms} ms, bound {fwd_bound[0]} ms ({fwd_bound[1]})")
            print(f"[kernel] stem_conv_wgrad {shape}: {wg_ms} ms, plain (cuDNN f32 "
                  f"conv3d_weight) {wg_plain_ms} ms, library (cuDNN bf16 conv3d_weight) "
                  f"{wg_lib_ms} ms, bound {wg_bound[0]} ms ({wg_bound[1]})")
            results["stem_conv_fwd"] = dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
                                            library_ms=fwd_plain_ms, bound=fwd_bound)
            results["stem_conv_wgrad"] = dict(max_abs_err=wg_err, ms=wg_ms, plain_ms=wg_plain_ms,
                                              library_ms=wg_lib_ms, bound=wg_bound)
            del x_ncdhw, g_ncdhw
            stem_schedules(sc, x, w, y, gy, kt, alone, results)
        del x, y, gy, dw, dref
    torch.cuda.empty_cache()
    probe_launches = window_probes(wp, dev, in_turns, results)

    scfg = one_card_cfg(tconfig, SPEED_CONFIG)
    sb, sk, st = scfg.DATA.BATCHSIZE_PER_GPU, scfg.DATA.NUM_CLIP, scfg.DATA.NUM_FRAMES
    ss = int(scfg.AUG.TARGET_SIZE)
    sw_in, sh_in = ingest_geometry(scfg, "train")
    mean, std = tuple(scfg.DATA.MEAN), tuple(scfg.DATA.STD)
    preset_color = tuple(scfg.AUG.COLOR)
    # K3's instances (store width x output type): registers, spills and
    # static shared memory from the build's ptxas -v report; a spill fails
    aug_usage = fa.kernel_usage()
    for (vw, odt), use in sorted(aug_usage.items()):
        print(f"[kernel] fused_aug_kernel<{vw}, {odt}>: {use['registers']} registers, spill stores "
              f"{use['spill_stores']} B, loads {use['spill_loads']} B, static shared {use['smem']} B")
        check(use["spill_stores"] == use["spill_loads"] == 0, f"fused_aug_kernel<{vw}, {odt}> spills")
    check(len(aug_usage) == 6, f"the fused aug library has {len(aug_usage)} kernel instances, not 6")
    aug_err = 0.0
    # the speed path runs its b * k clips as one batch through the aug, at the
    # preset's colour probability and at p = 1; so does X3D-M's PALLAS_AUG
    # variant (phase 7c), at its 16-frame clips; then the card tests' edge
    # shapes
    xcfg = one_card_cfg(tconfig, X3D_CONFIG)
    xw_in, xh_in = ingest_geometry(xcfg, "train")
    x_color = tuple(xcfg.AUG.COLOR)
    aug_cases = [((sb * sk, st, sh_in, sw_in, 3), ss, None, None, (preset_color, (1.0,) + preset_color[1:]),
                  mean, std),
                 ((xcfg.DATA.BATCHSIZE_PER_GPU * xcfg.DATA.NUM_CLIP, xcfg.DATA.NUM_FRAMES, xh_in, xw_in, 3),
                  int(xcfg.AUG.TARGET_SIZE), None, None, (x_color, (1.0,) + x_color[1:]),
                  tuple(xcfg.DATA.MEAN), tuple(xcfg.DATA.STD))]
    aug_cases += [(shape, size, tops, lefts, (AUG_ALL_ON,), mean, std)
                  for shape, size, tops, lefts in AUG_EDGE_SHAPES]
    for shape, size, tops, lefts, colors, a_mean, a_std in aug_cases:
        clips = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
        clips[:, 0, :, : shape[3] // 3] = clips[:, 0, :, : shape[3] // 3, :1]  # gray pixels
        for out_dtype in (torch.float32, torch.bfloat16):
            vw = fa.plan(*shape[:4], size)["vector"]
            kp = fa.plan(*shape[:4], size, out_dtype, aug_usage[(vw, str(out_dtype).split(".")[1])]["registers"])
            print(f"[kernel] fused aug plan {shape} crop {size} {out_dtype}: cluster {kp['cluster']} x band "
                  f"{kp['band']} rows {kp['bands'][-1:]} last, {kp['threads']} threads "
                  f"({kp['items_per_thread']} groups of 4 pixels a thread), pitch {kp['pitch']} B, "
                  f"shared {kp['smem']} B dynamic + {kp['smem_total'] - kp['smem']} static, stores of {kp['vector']} "
                  f"({kp['store_bytes']} B), grid {kp['grid']}, {kp['per_sm']} CTAs an SM: "
                  f"{kp['waves']} waves")
        for color in colors:
            prm = fa.sample_simple_aug(shape[0], shape[2], shape[3], size, color, g)
            for key, offsets in (("tops", tops), ("lefts", lefts)):
                if offsets is not None:
                    prm[key] = torch.tensor(offsets, dtype=torch.int32, device=dev)
            for out_dtype in (torch.float32, torch.bfloat16):
                got = fa.fused_simple_aug(clips, prm, size, a_mean, a_std, out_dtype)
                want = fa.fused_simple_aug_plain(clips, prm, size, a_mean, a_std, out_dtype)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                aug_err = max(aug_err, err)
                print(f"[kernel] fused_simple_aug {shape} crop {size} p {color[0]} {out_dtype}: "
                      f"max_abs_err {err} (bound: 0, exact), equal {torch.equal(got, want)}")
                check(torch.equal(got, want), f"fused_simple_aug disagrees at {shape} {out_dtype}")
                if shape[0] == sb * sk and color == preset_color:
                    # the card's time: AUG_REPS calls queued behind a sleep
                    # (the wrapper's host work, ~0.05-0.1 ms a call, is
                    # hidden by the step's other work on the path)
                    aug_ms, aug_plain_ms = queued_in_turns(
                        lambda: fa.fused_simple_aug(clips, prm, size, a_mean, a_std, out_dtype),
                        lambda: fa.fused_simple_aug_plain(clips, prm, size, a_mean, a_std, out_dtype),
                        AUG_REPS)
                    n_out = got.numel()
                    applied = float(prm["apply"].float().mean())
                    aug_bound = bound(n_out + 7 * 4 * shape[0] + n_out * got.element_size(),
                                      AUG_OPS_PER_ELEMENT * n_out * applied + 2 * n_out, "f32")
                    print(f"[kernel] fused_simple_aug {shape} crop {size} {out_dtype}: {aug_ms} ms, "
                          f"plain {aug_plain_ms} ms, bound {aug_bound[0]} ms ({aug_bound[1]}), "
                          f"{aug_bound[0] / aug_ms} of it, no single library call")
                    if out_dtype == torch.float32:  # the speed path's output type (AUG_COMPUTE_OUT off)
                        results["fused_simple_aug"] = dict(ms=aug_ms, plain_ms=aug_plain_ms,
                                                           library_ms=None, bound=aug_bound)
                del got, want
        del clips
    results["fused_simple_aug"]["max_abs_err"] = aug_err
    torch.cuda.empty_cache()

    # flash attention at every distinct shape of the masked path's encoder (2
    # views as one batch), each weighted by the blocks that run it, and a
    # ragged shape; bounds stated with the card tests' reasoning
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    mvcfg = one_card_cfg(tconfig, MASKED_CONFIG)
    mk = mvcfg.DATA.NUM_CLIP * mvcfg.DATA.BATCHSIZE_PER_GPU
    per_block = attention_shapes(mvcfg, mk)
    uses = {sh: per_block.count(sh) for sh in per_block}
    # and path (c)'s (phase 7h): each attention of ContrastiveModel over
    # MViT-S, one view's clips a call; checked, not timed (its step is),
    # but for its two head-dim-768 shapes (the width-768 kernels), timed
    # beside the float32 pair that ran them before
    con_shapes = path_c_shapes(tconfig)
    check(all(fl.route(torch.bfloat16, sh[4]) == "wgmma" for sh in con_shapes),
          "a path (c) attention routes to the float32 pair")
    con_wide = sorted({sh for sh in con_shapes if fl.padded_dim(sh[4]) == max(fl.TILES)})
    con_bf16 = sorted(set(con_shapes) - set(uses) - set(con_wide))
    print(f"[kernel] flash: path (c)'s attention shapes {con_shapes}")
    totals = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound=[0.0, 0.0], max_abs_err=0.0)
              for name in ("flash_mha_fwd", "flash_mha_bwd")}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    usage = fl.kernel_usage()  # ptxas -v of the build: registers and spills per kernel
    for shape in sorted(uses, key=lambda sh: -uses[sh]) + [(2, 2, 1001, 77, 72)] + con_bf16 + con_wide:
        b_, h_, nq, nk, d = shape
        kplan = fl.plan(b_ * h_, nq, nk, d)
        per_sm = fl.occupancy(kplan)
        wide = kplan["dq"]["dsplit"] > 2  # the forward's shared S, dQ the GEMM on dS
        grids = {"fwd": kplan["fwd"]["grid"], "bwd_pre": (math.ceil(b_ * h_ * nq / 8), 1, 1),
                 "dkdv": kplan["dkdv"]["grid"], "dq": kplan["dq"]["grid"]}
        if kplan["fwd"]["part_bytes"]:
            grids["combine"] = (64, kplan["fwd"]["grid"][0] - kplan["fwd"]["whole"], 1)
        if kplan["splits"] > 1:
            grids["reduce"] = (min(b_ * h_ * nk * d // 256 + 1, 132 * 8), 1, 1)
        for kname, grid in grids.items():
            blocks = grid[0] * grid[1] * grid[2]
            resident = per_sm.get(kname)
            waves = f", {resident} a SM: {blocks / (sms * resident)} waves" if resident else ""
            kernel = {"fwd": "flash_fwd_kernel", "bwd_pre": "flash_bwd_pre_kernel",
                      "dkdv": "flash_bwd_dkdv_kernel",
                      "dq": "flash_bwd_dq_gemm_kernel" if wide else "flash_bwd_dq_kernel",
                      "combine": "flash_fwd_combine_kernel", "reduce": "flash_bwd_reduce_kernel"}[kname]
            use = usage[(kernel, kplan["dp"] if kname in per_sm or kname == "combine" else None)]
            print(f"[kernel] flash {shape} {kname}: grid {grid}, {blocks} blocks{waves}; "
                  f"{kplan[kname]['warps'] if kname in per_sm else 8} warps, {use['registers']} "
                  f"registers, spill stores {use['spill_stores']} B, loads {use['spill_loads']} B"
                  + (f", {kplan[kname]['smem']} B shared" if kname in per_sm else ""))
            if kplan["dp"] <= 288 or wide:
                check(use["spill_stores"] == use["spill_loads"] == 0,
                      f"flash kernel {kernel} spills registers at head dim {d}")
        print(f"[kernel] flash {shape}: width {kplan['dp']}, dK/dV splits {kplan['splits']} "
              f"(scratch {kplan['scratch_bytes']} B)" + (
                  f", forward tiles split over keys past {kplan['fwd']['whole']}: {kplan['fwd']['ksplit']} "
                  f"ranges each ({kplan['fwd']['part_bytes']} B of partials), dS scratch "
                  f"{kplan['ds_bytes']} B" if wide else ""))
        scale = d ** -0.5
        errs, (q, k_, v, do, o, lse, qr, kr, vr, ref) = k4_against_plain(fl, shape, dev, g)
        for key, err in errs.items():
            totals[key]["max_abs_err"] = max(totals[key]["max_abs_err"], err)
        if shape in con_bf16:
            del q, k_, v, do, o, lse, qr, kr, vr, ref
            torch.cuda.empty_cache()
            continue
        n_use = uses.get(shape, 0)  # 0: the ragged check, timed but not in the totals
        # K4 and SDPA: K4_REPS calls back to back a sample, so the wrappers'
        # host time overlaps the card's work as it does on the path
        fwd_ms, fwd_plain_ms = in_turns(lambda: fl.flash_mha_fwd(q, k_, v, scale),
                                        lambda: fl.flash_mha_plain(qr, kr, vr, scale), K4_REPS)
        bwd_ms, bwd_plain_ms = in_turns(
            lambda: fl.flash_mha_bwd(q, k_, v, o, lse, do, scale),
            lambda: torch.autograd.grad(ref, (qr, kr, vr), do.float(), retain_graph=True), K4_REPS)
        pair = ""
        if shape in con_wide:  # the float32 pair on the same bf16 tensors: the route before width 768
            f32_fwd_ms, _ = in_turns(lambda: fl.flash_f32_fwd(q, k_, v, scale),
                                     lambda: fl.flash_mha_fwd(q, k_, v, scale))
            f32_bwd_ms, _ = in_turns(lambda: fl.flash_f32_bwd(q, k_, v, o, lse, do, scale),
                                     lambda: fl.flash_mha_bwd(q, k_, v, o, lse, do, scale))
            pair = f"; the float32 pair on the same bf16 inputs: fwd {f32_fwd_ms} ms, bwd {f32_bwd_ms} ms"
        backend = sdpa_backend(q, k_, v, scale)
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k_, v))
        with sdpa_kernel([backend]):
            lib_fwd_ms = alone(lambda: F.scaled_dot_product_attention(q, k_, v, scale=scale), K4_REPS)
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            lib_bwd_ms = alone(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                           retain_graph=True), K4_REPS)
        work = b_ * h_ * nq * nk * d
        io = 2.0 * (b_ * h_ * (2 * nq + 2 * nk) * d)  # q, k, v, o in bf16
        fwd_bound = bound(io + 4.0 * b_ * h_ * nq, 4.0 * work, "bf16")
        bwd_bound = bound(io + 2.0 * b_ * h_ * (2 * nq + 2 * nk) * d + 4.0 * b_ * h_ * nq,
                          10.0 * work, "bf16")
        print(f"[kernel] flash {shape} x{n_use} blocks: fwd {fwd_ms} ms (plain {fwd_plain_ms}, "
              f"SDPA {lib_fwd_ms}, bound {fwd_bound[0]} {fwd_bound[1]}, {fwd_bound[0] / fwd_ms} of "
              f"it); bwd {bwd_ms} ms (plain {bwd_plain_ms}, SDPA {lib_bwd_ms}, bound {bwd_bound[0]} "
              f"{bwd_bound[1]}, {bwd_bound[0] / bwd_ms} of it); SDPA fwd+bwd "
              f"{lib_fwd_ms + lib_bwd_ms} ms by {backend.name}{pair}")
        if shape in con_wide:  # width 768 against SDPA and the float32 pair it replaced (reported)
            print(f"[kernel] flash width 768 at {shape}: fwd {lib_fwd_ms / fwd_ms}x SDPA's speed, "
                  f"{f32_fwd_ms / fwd_ms}x the float32 pair's; bwd {lib_bwd_ms / bwd_ms}x SDPA's, "
                  f"{f32_bwd_ms / bwd_ms}x the pair's")
        for key, vals in (("flash_mha_fwd", (fwd_ms, fwd_plain_ms, lib_fwd_ms, fwd_bound)),
                          ("flash_mha_bwd", (bwd_ms, bwd_plain_ms, lib_bwd_ms, bwd_bound))):
            tot = totals[key]
            tot["ms"] += n_use * vals[0]
            tot["plain_ms"] += n_use * vals[1]
            tot["library_ms"] += n_use * vals[2]
            tot["bound"][0] += n_use * vals[3][0]
            tot["bound"][1] += n_use * (1.0 if vals[3][1] == "operations" else 0.0)
        del q, k_, v, do, o, lse, qr, kr, vr, ref, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    for key, tot in totals.items():
        # one pass of the 48-block encoder over both views: per-shape medians
        # times the blocks that run the shape
        tot["bound"] = (tot["bound"][0], "operations" if tot["bound"][1] * 2 >= len(per_block) else "bytes")
        print(f"[kernel] {key} over the encoder's {len(per_block)} blocks: {tot['ms']} ms, plain "
              f"{tot['plain_ms']} ms, SDPA {tot['library_ms']} ms, bound {tot['bound'][0]} ms "
              f"({tot['bound'][1]}; {tot['bound'][0] / tot['ms']} of it), max_abs_err "
              f"{tot['max_abs_err']}")
        results[key] = tot

    # K4's float32 pair (csrc/flash_attention_f32.cu): what the tensor-core
    # kernels do not take, routed by flash_mha_fwd/bwd, at every float32
    # shape of the masked path's encoder and two wide head dims
    results.update(flash_f32_table(fl, build, dev, g, uses, per_block, in_turns, alone, sms))
    k4_checked = set(uses) | set(con_bf16) | set(con_wide)
    print(f"[kernel] card after the flash timings: {card_state()}")

    print(f"[phase] 4 starts at {time.perf_counter() - t_start} s")
    # -- 4. small input: the card's bf16 forward against a CPU float32 one --------
    small = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, t, 64, 64, 3)).astype(np.float32))
    for name, mcfg, width in (("SlowFast-R50 BYOL", cfg, cfg.CONTRASTIVE.DIM),
                              ("Slow-R50 speed", scfg, scfg.MODEL.NUM_CLASSES)):
        ref_cfg = mcfg.clone()
        ref_cfg.TPU.COMPUTE_DTYPE = "float32"
        ref_model = build_model(ref_cfg, "cpu", seed=0).eval()
        card_model = build_model(mcfg, dev, seed=0).eval()
        x_small = small[:, : mcfg.DATA.NUM_FRAMES]
        with torch.no_grad():
            want = ref_model(x_small)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                got = card_model(x_small.to(dev).bfloat16())
        outs = zip(("projection", "prediction"), got, want) if isinstance(got, list) else [("logits", got, want)]
        for out_name, a, r in outs:
            check(tuple(a.shape) == (2, width), f"{name} {out_name} has shape {tuple(a.shape)}")
            rel = float((a.float().cpu() - r).abs().max() / r.abs().max())
            # bf16 activations round at 2^-8 through ~50 layers: ~1e-2 (7.8e-3
            # for a CPU bf16 run of the SlowFast check); a wrong layer is O(1)
            print(f"[small] {name} {out_name}: max rel err vs CPU float32 {rel} (bound 5e-2)")
            check(math.isfinite(rel) and rel <= 5e-2, f"the card's {name} {out_name} disagrees with the CPU")
        del ref_model, card_model, got, want
    torch.cuda.empty_cache()
    eval_forward(tconfig, dev)

    small_cfg = mvcfg.clone()
    small_cfg.DATA.NUM_FRAMES = 4
    small_cfg.DATA.TRAIN_CROP_SIZE = small_cfg.DATA.TEST_CROP_SIZE = small_cfg.AUG.TARGET_SIZE = 64
    ref_cfg = small_cfg.clone()
    ref_cfg.TPU.COMPUTE_DTYPE = "float32"
    ref_model = build_model(ref_cfg, "cpu", seed=0).eval()
    card_model = build_model(small_cfg, dev, seed=0).eval()
    x_small = small[:, :4]
    mask_small = torch.from_numpy(np.stack(
        [build_mask_generator(small_cfg)(np.random.default_rng(i)) for i in range(2)]))
    with torch.no_grad():
        want = ref_model(x_small, loader_mask=mask_small)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = card_model(x_small.to(dev).bfloat16(), loader_mask=mask_small.to(dev))
    # the HOG label is not compared: it follows the input's dtype (bf16 on the
    # card, as in JAX), whose coarse phase moves pixels across orientation
    # bins; the CPU parity tests hold it to JAX in float32
    for out_name, a, r in (("HOG prediction", got[0][0], want[0][0]),
                           ("joint projection", got[4], want[4])):
        check(tuple(a.shape) == tuple(r.shape), f"MViT-L {out_name} has shape {tuple(a.shape)}")
        rel = float((a.float().cpu() - r).abs().max() / r.abs().max())
        print(f"[small] MViT-L MaskFeat {out_name} {tuple(a.shape)}: max rel err vs CPU float32 {rel} "
              f"(bound 5e-2)")
        check(math.isfinite(rel) and rel <= 5e-2, f"the card's MViT-L {out_name} disagrees with the CPU")
    del card_model, got

    # the same MViT-L in float32 on the card: TPU.COMPUTE_DTYPE float32 with
    # flash attention takes K4's float32 pair, once per block in the forward
    f32_model = build_model(ref_cfg, dev, seed=0).eval()
    n_attn = sum(1 for item in f32_model.encoder.plan if item[0] == "transition") + sum(
        item[3] - item[2] for item in f32_model.encoder.plan if item[0] == "segment")
    for fn in (fl.flash_mha_fwd, fl.flash_mha_bwd, fl.flash_f32_fwd, fl.flash_f32_bwd):
        fn.launches = 0
    with torch.no_grad():
        got = f32_model(x_small.to(dev), loader_mask=mask_small.to(dev))
    torch.cuda.synchronize()
    fwd_launches = fl.flash_f32_fwd.launches
    for out_name, a, r in (("HOG prediction", got[0][0], want[0][0]),
                           ("joint projection", got[4], want[4])):
        check(a.dtype == torch.float32, f"the float32 MViT-L {out_name} is {a.dtype}")
        rel = float((a.cpu() - r).abs().max() / r.abs().max())
        # float32 on both sides (TF32 off), sums in other orders through 48
        # blocks: ~1e-6 a layer; a wrong kernel is O(1)
        print(f"[small] MViT-L MaskFeat float32 on the card {out_name}: max rel err vs CPU float32 {rel} "
              f"(bound 1e-3)")
        check(math.isfinite(rel) and rel <= 1e-3, f"the card's float32 MViT-L {out_name} disagrees with the CPU")
    out = f32_model(x_small.to(dev), loader_mask=mask_small.to(dev))
    (out[0][0].pow(2).mean() + out[4].pow(2).mean()).backward()
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(p.grad).all()) for p in f32_model.parameters() if p.grad is not None),
          "the float32 MViT-L's gradients are not finite")
    launches_f32 = {"flash_f32_fwd": fl.flash_f32_fwd.launches, "flash_f32_bwd": fl.flash_f32_bwd.launches}
    print(f"[small] MViT-L float32 on the card: {n_attn} attention blocks; K4 float32 pair launches "
          f"{launches_f32} (forward alone {fwd_launches}), tensor-core K4 "
          f"{(fl.flash_mha_fwd.launches, fl.flash_mha_bwd.launches)}")
    check(fwd_launches == n_attn, "the float32 forward did not launch the float32 pair once a block")
    check(launches_f32["flash_f32_bwd"] == n_attn, "the float32 backward did not launch the pair once a block")
    check(fl.flash_mha_fwd.launches == fl.flash_mha_bwd.launches == 0,
          "the float32 MViT-L reached the bf16 kernels")
    del ref_model, f32_model, got, want, out
    torch.cuda.empty_cache()
    advise_forward(tconfig, dev)
    advise_forward(tconfig, dev, "ViT-B/16 + video_swin", ADVISE_SWIN)
    small_forwards(tconfig, dev)
    swin_forward(tconfig, dev)
    mae_forward(tconfig, dev)
    mvit_v2_forward(tconfig, dev)
    ra_exact_small(tconfig, dev)
    mvit_knobs_forward(tconfig, dev)
    fuse_inter_forward(tconfig, dev)

    print(f"[phase] 5 starts at {time.perf_counter() - t_start} s")
    # -- 5. the BYOL path ---------------------------------------------------------
    model = build_model(cfg, dev, seed=0)
    params = dict(model.named_parameters())
    bundle = build_tx(cfg, params)
    ssl = init_ssl_state(cfg, model, torch.Generator(device=dev).manual_seed(7))
    state = TrainState(model, bundle.tx.init(params), 0, ssl)
    step = make_train_step(cfg, bundle, build_device_aug(cfg, "train"))
    w_in, h_in = ingest_geometry(cfg, "train")
    rng = np.random.default_rng(0)
    clips = torch.from_numpy(
        rng.integers(0, 256, size=(b, k, t, h_in, w_in, 3), dtype=np.uint8)).to(dev)
    infos = {"item_id": torch.from_numpy(rng.integers(0, cfg.CONTRASTIVE.LENGTH, (b,))).to(dev)}
    aug_gen = torch.Generator(device=dev).manual_seed(0)
    n_params = sum(p.numel() for p in params.values())
    print(f"[byol] SlowFast-R{cfg.RESNET.DEPTH} BYOL, {n_params} params, clips "
          f"{tuple(clips.shape)} uint8, {cfg.TPU.COMPUTE_DTYPE}, REMAT {cfg.TPU.REMAT}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.stem_conv_fwd.launches = 0
    sc.stem_conv_wgrad.launches = 0
    fa.fused_simple_aug.launches = 0
    fl.flash_mha_fwd.launches = 0
    fl.flash_mha_bwd.launches = 0
    step_ms = []
    with bn_on_kernels("BYOL step", WARMUP_STEPS + TIMED_STEPS, model, state.ssl["ema_model"]):
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            t0 = time.perf_counter()
            stats = step(state, clips, infos, aug_gen, LR, EPOCH_EXACT)
            loss, gnorm = float(stats["loss_byol"]), float(stats["grad_norm"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            print(f"[byol] step {i}: loss {loss} grad_norm {gnorm} ({step_ms[-1]} ms)")
            check(math.isfinite(loss) and math.isfinite(gnorm), f"step {i} is not finite")
    launches = {"stem_conv_fwd": sc.stem_conv_fwd.launches,
                "stem_conv_wgrad": sc.stem_conv_wgrad.launches}
    peak = torch.cuda.max_memory_allocated()

    check(state.step == WARMUP_STEPS + TIMED_STEPS, "the state did not advance")
    for name, tensors in (("params", model.parameters()),
                          ("momentum encoder", state.ssl["ema_model"].parameters()),
                          ("kNN bank", [state.ssl["knn_mem"]])):
        check(all(bool(torch.isfinite(p).all()) for p in tensors), f"{name} not finite")
    median_ms = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[byol] median step {median_ms} ms over {TIMED_STEPS} steps, "
          f"{k * b * 1e3 / median_ms} clip-views/s ({b} clips x {k} views), "
          f"peak allocated {peak} bytes")
    print(f"[byol] launches during the steps: {launches}, fused_simple_aug "
          f"{fa.fused_simple_aug.launches}")
    byol_ms, byol_peak = median_ms, peak  # phase 7g reads CONTRASTIVE.SEQUENTIAL's peak against these
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the BYOL path")
    del model, params, bundle, ssl, state, step, stats
    torch.cuda.empty_cache()

    # the stem's other launch schedules on the same step: the online forward
    # and the momentum encoder's each launch K1 once per chunk of the k * b
    # clips, the backward K2 once per chunk; wgrad-only launches no K1
    n_stem = k * b
    n_steps = VARIANT_WARMUP + VARIANT_TIMED
    for label, key, value, chunk, names in (
            ("chunk 8", "TPU.PALLAS_STEM_CHUNK", 8, 8,
             ("stem_conv_fwd_chunked", "stem_conv_wgrad_chunked")),
            ("wgrad-only", "TPU.PALLAS_STEM_WGRAD_ONLY", True, sc.WGRAD_CHUNK,
             (None, "stem_conv_wgrad_only"))):
        chunks = n_stem // sc.largest_divisor(n_stem, chunk)
        want = ((2 * chunks if names[0] else 0) * n_steps, chunks * n_steps)
        vcfg = cfg.clone()
        setattr(vcfg.TPU, key.split(".")[1], value)
        model = build_model(vcfg, dev, seed=0)
        params = dict(model.named_parameters())
        bundle = build_tx(vcfg, params)
        ssl = init_ssl_state(vcfg, model, torch.Generator(device=dev).manual_seed(7))
        state = TrainState(model, bundle.tx.init(params), 0, ssl)
        step = make_train_step(vcfg, bundle, build_device_aug(vcfg, "train"))
        torch.cuda.synchronize()
        sc.stem_conv_fwd.launches = 0
        sc.stem_conv_wgrad.launches = 0
        step_ms = []
        for i in range(n_steps):
            t0 = time.perf_counter()
            stats = step(state, clips, infos, aug_gen, LR, EPOCH_EXACT)
            loss, gnorm = float(stats["loss_byol"]), float(stats["grad_norm"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check(math.isfinite(loss) and math.isfinite(gnorm), f"{label} step {i} is not finite")
        got = (sc.stem_conv_fwd.launches, sc.stem_conv_wgrad.launches)
        median_ms = statistics.median(step_ms[VARIANT_WARMUP:])
        print(f"[byol] {label} ({key} {value}): median step {median_ms} ms over {VARIANT_TIMED} steps "
              f"(all: {step_ms}), loss {loss}, K1/K2 launches {got} (schedule: {want})")
        check(got == want, f"the {label} variant's K1/K2 launches differ from its chunk schedule")
        launches.update({name: n for name, n in zip(names, got) if name})
        del model, params, bundle, ssl, state, step, stats
        torch.cuda.empty_cache()
    del clips

    print(f"[phase] 6 starts at {time.perf_counter() - t_start} s")
    # -- 6. the speed path --------------------------------------------------------
    model = build_model(scfg, dev, seed=0)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    check(n_params == SLOW_R50_SPEED_PARAMS, f"Slow-R50 speed model has {n_params} params")
    bundle = build_tx(scfg, params)
    state = TrainState(model, bundle.tx.init(params), 0)
    step = make_train_step(scfg, bundle, build_device_aug(scfg, "train"))
    rng = np.random.default_rng(1)
    clips = torch.from_numpy(
        rng.integers(0, 256, size=(sb, sk, st, sh_in, sw_in, 3), dtype=np.uint8)).to(dev)
    # speed labels from a seed (SpeedClipSampler belongs to the loader slice)
    infos = {"spd_label": torch.from_numpy(
        rng.integers(0, scfg.MODEL.NUM_CLASSES, (sb, sk))).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(0)
    lr = get_lr_at_epoch(scfg, SPEED_EPOCH)
    print(f"[speed] Slow-R{scfg.RESNET.DEPTH} speed, {n_params} params, clips "
          f"{tuple(clips.shape)} uint8 -> crop {ss}, {scfg.TPU.COMPUTE_DTYPE}, REMAT "
          f"{scfg.TPU.REMAT}, dropout {scfg.MODEL.DROPOUT_RATE}, lr {lr} at epoch {SPEED_EPOCH}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.stem_conv_fwd.launches = 0
    sc.stem_conv_wgrad.launches = 0
    fa.fused_simple_aug.launches = 0
    step_ms = []
    n_steps = WARMUP_STEPS + TIMED_STEPS
    bn_before = {fn.__name__: fn.launches for fn in bnk.COUNTED}
    with bn_on_kernels("speed step", n_steps, model) as bn_seen:
        for i in range(n_steps):
            t0 = time.perf_counter()
            stats = step(state, clips, infos, gen, lr)
            vals = {name: float(v) for name, v in stats.items()}
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            print(f"[speed] step {i}: loss_spd {vals['loss_spd']} acc_spd {vals['acc_spd']} "
                  f"grad_norm {vals['grad_norm']} ({step_ms[-1]} ms)")
            check(all(math.isfinite(v) for v in vals.values()), f"speed step {i} is not finite")
    launches["fused_simple_aug"] = fa.fused_simple_aug.launches
    speed_stem = (sc.stem_conv_fwd.launches, sc.stem_conv_wgrad.launches)
    peak = torch.cuda.max_memory_allocated()
    check(state.step == WARMUP_STEPS + TIMED_STEPS, "the speed state did not advance")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "speed params not finite")
    median_ms = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[speed] median step {median_ms} ms over {TIMED_STEPS} steps, "
          f"{sb * sk * 1e3 / median_ms} clips/s ({sb} videos x {sk} clips), "
          f"peak allocated {peak} bytes")
    print(f"[speed] launches during the steps: fused_simple_aug {launches['fused_simple_aug']}, "
          f"stem kernels {speed_stem} (the slow stem is a plain conv)")
    check(launches["fused_simple_aug"] == WARMUP_STEPS + TIMED_STEPS,
          "fused_simple_aug was not launched once per speed step")
    # every BN a step, and again those of the stages REMAT recomputes
    n_bn = sum(isinstance(m, SyncBatchNorm) for m in model.modules())
    n_remat = sum(isinstance(m, SyncBatchNorm) for st in model.modules()
                  if isinstance(st, ResStage) and st.remat for m in st.modules())
    bn_step = {fn.__name__: (fn.launches - bn_before[fn.__name__]) / n_steps for fn in bnk.COUNTED}
    launches["bn_forward"] = bnk.bn_stats.launches - bn_before["bn_stats"]
    launches["bn_backward"] = bnk.bn_grad_stats.launches - bn_before["bn_grad_stats"]
    print(f"[speed] SyncBatchNorm's kernels a step: {bn_step}; {n_bn} BNs, {n_remat} of them recomputed")
    check(bn_step == {"bn_stats": n_bn + n_remat, "bn_apply": n_bn + n_remat, "bn_grad_stats": n_bn, "bn_dx": n_bn,
                      "channels_last": 0}, "a speed step's BNs did not run on their kernels once a call")
    speed_ms, speed_peak = median_ms, peak  # phase 7g reads TRAIN.SEQUENTIAL's peak against these
    del model, params, bundle, state, step, clips, stats
    torch.cuda.empty_cache()
    bn_kernel_rows(bn_seen, n_steps, dev, results)

    print(f"[phase] 7 starts at {time.perf_counter() - t_start} s")
    # -- 7. the masked path -------------------------------------------------------
    model = build_model(mvcfg, dev, seed=0)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    bundle = build_tx(mvcfg, params)
    state = TrainState(model, bundle.tx.init(params), 0)
    step = make_train_step(mvcfg, bundle, build_device_aug(mvcfg, "train"))
    mb, mk_, mt = mvcfg.DATA.BATCHSIZE_PER_GPU, mvcfg.DATA.NUM_CLIP, mvcfg.DATA.NUM_FRAMES
    mw_in, mh_in = ingest_geometry(mvcfg, "train")
    rng = np.random.default_rng(2)
    clips = torch.from_numpy(
        rng.integers(0, 256, size=(mb, mk_, mt, mh_in, mw_in, 3), dtype=np.uint8)).to(dev)
    mask_gen = build_mask_generator(mvcfg)  # the loader's, one block mask per clip and step
    grid = (mask_gen.temporal, mask_gen.height, mask_gen.width)
    masks = [torch.from_numpy(np.stack([mask_gen(rng) for _ in range(mb * mk_)])).reshape(
        mb, mk_, *grid).to(dev) for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    gen = torch.Generator(device=dev).manual_seed(0)
    lr = get_lr_at_epoch(mvcfg, MASKED_EPOCH)
    plan = model.encoder.plan
    n_transition = sum(1 for item in plan if item[0] == "transition")
    n_uniform = sum(item[3] - item[2] for item in plan if item[0] == "segment")
    # a uniform block's attention runs in the forward and again in the
    # reversible backward; a transition's again under REMAT's checkpoint
    fwd_per_step = 2 * n_uniform + (2 if mvcfg.TPU.REMAT else 1) * n_transition
    bwd_per_step = n_uniform + n_transition
    print(f"[masked] MViT-L MaskFeat + NT-Xent, {n_params} params, clips {tuple(clips.shape)} uint8 "
          f"-> OnlyCrop {mvcfg.AUG.TARGET_SIZE}, {mvcfg.TPU.COMPUTE_DTYPE}, REV {mvcfg.MVIT.REV.ENABLE} "
          f"(O1_SCAN {mvcfg.MVIT.REV.O1_SCAN}), REMAT {mvcfg.TPU.REMAT}, {n_transition} transitions + "
          f"{n_uniform} reversible blocks, mask ratio {float(masks[0].float().mean())}, "
          f"drop path {mvcfg.MVIT.DROPPATH_RATE}, lr {lr} at epoch {MASKED_EPOCH}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.stem_conv_fwd.launches = 0
    sc.stem_conv_wgrad.launches = 0
    fa.fused_simple_aug.launches = 0
    fl.flash_mha_fwd.launches = 0
    fl.flash_mha_bwd.launches = 0
    step_ms = []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        stats = step(state, clips, {"mask": masks[i]}, gen, lr)
        vals = {name: float(v) for name, v in stats.items()}
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[masked] step {i}: loss_mask {vals['loss_mask']} loss_nce {vals['loss_nce']} "
              f"grad_norm {vals['grad_norm']} ({step_ms[-1]} ms)")
        check(all(math.isfinite(vals[k]) for k in ("loss_mask", "loss_nce", "grad_norm")),
              f"masked step {i} is not finite")
    launches["flash_mha_fwd"] = fl.flash_mha_fwd.launches
    launches["flash_mha_bwd"] = fl.flash_mha_bwd.launches
    other = (sc.stem_conv_fwd.launches, sc.stem_conv_wgrad.launches, fa.fused_simple_aug.launches)
    peak = torch.cuda.max_memory_allocated()
    check(state.step == WARMUP_STEPS + TIMED_STEPS, "the masked state did not advance")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "masked params not finite")
    median_ms = statistics.median(step_ms[WARMUP_STEPS:])
    print(f"[masked] card after the steps: {card_state()}")
    print(f"[masked] median step {median_ms} ms over {TIMED_STEPS} steps, "
          f"{mb * mk_ * 1e3 / median_ms} clip-views/s ({mb} video x {mk_} views), "
          f"peak allocated {peak} bytes")
    steps = WARMUP_STEPS + TIMED_STEPS
    print(f"[masked] launches during the steps: flash_mha_fwd {launches['flash_mha_fwd']} "
          f"(expected {fwd_per_step * steps}), flash_mha_bwd {launches['flash_mha_bwd']} "
          f"(expected {bwd_per_step * steps}), stem and aug kernels {other}")
    check(launches["flash_mha_fwd"] == fwd_per_step * steps > 0,
          "flash_mha_fwd launches differ from the schedule's count")
    check(launches["flash_mha_bwd"] == bwd_per_step * steps > 0,
          "flash_mha_bwd launches differ from the schedule's count")

    del model, params, bundle, state, step, stats
    torch.cuda.empty_cache()

    # the same step with TPU.COMPUTE_DTYPE float32 (the precision baseline):
    # no autocast, flash attention through K4's float32 pair, as many
    # launches a step as the bf16 step's, and none of the tensor-core pair
    fcfg = mvcfg.clone()
    fcfg.TPU.COMPUTE_DTYPE = "float32"
    model = build_model(fcfg, dev, seed=0)
    params = dict(model.named_parameters())
    bundle = build_tx(fcfg, params)
    state = TrainState(model, bundle.tx.init(params), 0)
    step = make_train_step(fcfg, bundle, build_device_aug(fcfg, "train"))
    gen = torch.Generator(device=dev).manual_seed(0)
    f_steps = F32_WARMUP + F32_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (fl.flash_mha_fwd, fl.flash_mha_bwd, fl.flash_f32_fwd, fl.flash_f32_bwd):
        fn.launches = 0
    step_ms = []
    for i in range(f_steps):
        t0 = time.perf_counter()
        stats = step(state, clips, {"mask": masks[i]}, gen, lr)
        vals = {name: float(v) for name, v in stats.items()}
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[masked f32] step {i}: loss_mask {vals['loss_mask']} loss_nce {vals['loss_nce']} "
              f"grad_norm {vals['grad_norm']} ({step_ms[-1]} ms)")
        check(all(math.isfinite(vals[k]) for k in ("loss_mask", "loss_nce", "grad_norm")),
              f"float32 masked step {i} is not finite")
    launches["flash_f32_fwd"] = fl.flash_f32_fwd.launches
    launches["flash_f32_bwd"] = fl.flash_f32_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    check(state.step == f_steps, "the float32 masked state did not advance")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "float32 masked params not finite")
    median_ms = statistics.median(step_ms[F32_WARMUP:])
    print(f"[masked f32] card after the steps: {card_state()}")
    print(f"[masked f32] MViT-L MaskFeat + NT-Xent in {fcfg.TPU.COMPUTE_DTYPE}: median step {median_ms} ms "
          f"over {F32_TIMED} steps (all: {step_ms}), {mb * mk_ * 1e3 / median_ms} clip-views/s, peak "
          f"allocated {peak} bytes")
    print(f"[masked f32] launches during the steps: flash_f32_fwd {launches['flash_f32_fwd']} (expected "
          f"{fwd_per_step * f_steps}), flash_f32_bwd {launches['flash_f32_bwd']} (expected "
          f"{bwd_per_step * f_steps}), tensor-core K4 {(fl.flash_mha_fwd.launches, fl.flash_mha_bwd.launches)}")
    check(launches["flash_f32_fwd"] == fwd_per_step * f_steps > 0,
          "flash_f32_fwd launches in the float32 step differ from the schedule's count")
    check(launches["flash_f32_bwd"] == bwd_per_step * f_steps > 0,
          "flash_f32_bwd launches in the float32 step differ from the schedule's count")
    check(fl.flash_mha_fwd.launches == fl.flash_mha_bwd.launches == 0,
          "the float32 masked step reached the tensor-core flash kernels")
    del model, params, bundle, state, step, clips, masks, stats
    torch.cuda.empty_cache()

    print(f"[phase] 7b starts at {time.perf_counter() - t_start} s")
    # -- 7b. the AdViSe path: no kernel on the preset's own path -------------------
    acfg = one_card_cfg(tconfig, ADVISE_CONFIG)
    _, _, adv_launches, tower_same, _ = advise_steps(acfg, "AdViSe.yaml", WARMUP_STEPS, TIMED_STEPS, dev,
                                                     profiled=True)
    check(tower_same, "the frozen CLIP tower changed in the AdViSe steps")
    check(not any(adv_launches.values()), "the AdViSe step launched a kernel: its path has none")
    for label, over in ADVISE_VARIANTS.items():
        vcfg = acfg.clone()
        for key, value in over.items():
            sec, leaf = key.split(".")
            vcfg[sec][leaf] = value
        _, _, v_launches, tower_same, twins_moved = advise_steps(vcfg, label, VARIANT_WARMUP, VARIANT_TIMED, dev)
        if vcfg.TM.FROM_SCRATCH:
            check(not tower_same and twins_moved, f"AdViSe {label}: the tower or the twins did not move")
        if vcfg.TPU.PALLAS_AUG:
            advise_k3 = v_launches["fused_simple_aug"]
            print(f"[advise] {label}: fused_simple_aug launches {advise_k3} in "
                  f"{VARIANT_WARMUP + VARIANT_TIMED} steps")
            check(advise_k3 == VARIANT_WARMUP + VARIANT_TIMED,
                  f"AdViSe {label}: fused_simple_aug was not launched once a step")

    # AdViSe with the video_swin temporal head, the preset's speed task and
    # speed_byol (the Swin layer's BYOL twin): no kernel on either
    for task in ("speed", "speed_byol"):
        vcfg = one_card_cfg(tconfig, ADVISE_CONFIG, {**ADVISE_SWIN, "SSL.TASK": task})
        _, _, v_launches, tower_same, twins_moved = advise_steps(vcfg, f"video_swin {task}", WARMUP_STEPS,
                                                                 TIMED_STEPS, dev)
        check(tower_same, f"AdViSe video_swin {task}: the frozen CLIP tower changed")
        check(task == "speed" or twins_moved, "AdViSe video_swin speed_byol: the twins did not move")
        check(not any(v_launches.values()), f"the AdViSe video_swin {task} step launched a kernel")

    print(f"[phase] 7c starts at {time.perf_counter() - t_start} s")
    # -- 7c. the X3D path, 7d. the MoCo path, 7e. the Swin path, 7f. the MAE
    # path: no kernel -------------------------------------------------------------
    x3d_path(tconfig, dev)
    moco_path(tconfig, dev)
    swin_path(tconfig, dev)
    mae_path(tconfig, dev)

    print(f"[phase] 7g starts at {time.perf_counter() - t_start} s")
    # -- 7g. the rest of the contrastive engine and the solver: K1/K2 (and K3
    # on TRAIN.SEQUENTIAL) by each variant's schedule -------------------------
    for name, n in contrastive_path(tconfig, dev, byol_ms, byol_peak).items():
        launches[name] += n
    launches["fused_simple_aug"] += speed_sequential(tconfig, dev, speed_ms, speed_peak)
    solver_chains(tconfig, dev)

    print(f"[phase] 7h starts at {time.perf_counter() - t_start} s")
    # -- 7h. the op-exact RandAugment (path (a)) and ContrastiveModel over
    # MViT (path (c)): K1/K2 and K4 by their schedules -------------------------
    t_7h = time.perf_counter()
    for name, n in ra_exact_path(tconfig, dev, byol_ms, byol_peak).items():
        launches[name] += n
    for name, n in mvit_con_path(tconfig, dev, byol_ms, byol_peak, k4_checked).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[7h] phase 7h {time.perf_counter() - t_7h} s")

    print(f"[phase] 8 starts at {time.perf_counter() - t_start} s")
    # -- 8. the entry point ---------------------------------------------------------
    import shutil
    from pathlib import Path

    from advise_tpu_torch.engine.checkpoint import STATE_FILE, tensors_digest

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    first = run_entry_point(["SOLVER.MAX_EPOCH", "1"], "1 epoch")
    ckpt_dir = Path(RUN_DIR) / "checkpoints"
    for name in ("Model_Epoch_0000", "Model_Best"):
        check((ckpt_dir / name / STATE_FILE).is_file() and (ckpt_dir / f"{name}.meta.npy").is_file(),
              f"the entry point did not write {name}")
    check((Path(RUN_DIR) / "log.txt").is_file(), "the entry point wrote no log.txt")
    saved = tensors_digest(torch.load(ckpt_dir / "Model_Epoch_0000" / STATE_FILE, map_location="cpu",
                                      weights_only=False)["model"])
    iters = RUN_VIDEOS // b
    second = run_entry_point(["SOLVER.MAX_EPOCH", "2", "TRAIN.AUTO_RESUME", "True",
                              "TPU.PROFILE_DIR", f"{RUN_DIR}/profile", "TPU.PROFILE_START", str(iters),
                              "TPU.PROFILE_STEPS", "2"], "resume to 2 epochs")
    check((ckpt_dir / "Model_Epoch_0001" / STATE_FILE).is_file(), "the resumed run wrote no Model_Epoch_0001")
    for rec, epochs, start_step, label in ((first, 1, 0, "first run"), (second, 1, iters, "resumed run")):
        losses = [st["loss_byol"] for st in rec["stats"]]
        n_iter = len(rec["iter_s"])
        want = (2 * n_iter + epochs * RUN_KNN_BATCHES, n_iter)  # + the probe batch's forward
        got = (rec["launches"]["stem_conv_fwd"], rec["launches"]["stem_conv_wgrad"])
        print(f"[run] {label}: start epoch {rec['start_epoch']} step {rec['start_step']}, {n_iter} "
              f"iterations, losses {losses}, median iteration {statistics.median(rec['iter_s']) * 1e3} ms "
              f"(all: {[t * 1e3 for t in rec['iter_s']]}), loader wait per iteration median "
              f"{statistics.median(rec['wait_s']) * 1e3} ms (all: {[t * 1e3 for t in rec['wait_s']]}), "
              f"peak allocated {rec['peak_allocated_bytes']} bytes, K1/K2 launches {got} (expected "
              f"{want}), {rec['seconds']} s with start-up")
        # the input pipeline by stage (utils/host_times.py): the workers'
        # items (of which the resize) in thread-seconds, and the main
        # thread's wait for items, collate and pinned copy, per call
        split = {stage: f"{s * 1e3 / n} ms x {n} ({s * 1e3} ms in all)"
                 for stage, (s, n) in rec["host_s"].items()}
        print(f"[run] {label}: host stages {split}")
        check(n_iter == epochs * iters and rec["start_step"] == start_step, f"{label}: wrong schedule")
        check(all(math.isfinite(v) for st in rec["stats"] for v in st.values()), f"{label}: a loss is not finite")
        check(got == want, f"{label}: K1/K2 launches differ from the schedule")
    check(second["start_epoch"] == 1, "the resumed run did not start at epoch 1")
    print(f"[run] model sha256: end of the first run {first['model_sha256_end']}, Model_Epoch_0000 "
          f"{saved}, start of the resumed run {second['model_sha256']}")
    check(first["model_sha256_end"] == saved == second["model_sha256"],
          "the resumed model differs from the saved one")
    prof = second.get("profile")
    check(prof is not None, "the resumed run's profile window did not close")
    print(f"[run] profile window ({prof['steps']} iterations of the resumed run): wall {prof['wall_ms']} ms, "
          f"device busy {prof['busy_ms']} ms, idle share {prof['idle_share']}")

    # the speed preset through the entry point: K3 once an iteration; a
    # profiler window over the second iteration gives the idle share
    shutil.rmtree(SPEED_RUN_DIR, ignore_errors=True)
    spd = run_entry_point(["TPU.PROFILE_DIR", f"{SPEED_RUN_DIR}/profile", "TPU.PROFILE_START", "0",
                           "TPU.PROFILE_STEPS", "1"], "speed preset, 1 epoch", SPEED_CONFIG,
                          SPEED_RUN_DIR, SPEED_RUN_OVERRIDES)
    n_iter = len(spd["iter_s"])
    print(f"[run] speed preset: {n_iter} iterations, losses {[st['loss_spd'] for st in spd['stats']]}, "
          f"iterations {[t * 1e3 for t in spd['iter_s']]} ms, loader wait {[t * 1e3 for t in spd['wait_s']]} "
          f"ms, peak allocated {spd['peak_allocated_bytes']} bytes, fused_simple_aug launches "
          f"{spd['launches']['fused_simple_aug']}, {spd['seconds']} s with start-up")
    split = {stage: f"{s * 1e3 / n} ms x {n} ({s * 1e3} ms in all)" for stage, (s, n) in spd["host_s"].items()}
    print(f"[run] speed preset: host stages {split}")
    check(n_iter == SPEED_RUN_VIDEOS // sb and spd["start_step"] == 0, "speed preset: wrong schedule")
    check(all(math.isfinite(v) for st in spd["stats"] for v in st.values()), "speed preset: a loss is not finite")
    check(spd["launches"]["fused_simple_aug"] == n_iter,
          "speed preset: fused_simple_aug launches differ from the iterations")
    prof = spd.get("profile")
    check(prof is not None, "the speed run's profile window did not close")
    print(f"[run] speed preset profile window ({prof['steps']} iteration): wall {prof['wall_ms']} ms, device "
          f"busy {prof['busy_ms']} ms, idle share {prof['idle_share']}")
    # speed_val at the reference's VAL defaults: 224^2, 8 frames, stride 1,
    # RANGE [1,2,4,8], chunks of 2, a start every VAL.FPS (25) frames of the
    # 250-frame synthetic videos: 10 starts x 4 labels = 40 clips a video
    val = spd["speed_val"]
    val_clips = SPEED_RUN_VIDEOS * (scfg.DATA.SYNTHETIC_LENGTH // scfg.VAL.FPS) * len(scfg.VAL.RANGE)
    confusion = np.asarray(val["confusion"])
    print(f"[run] speed_val: {val['clips']} clips in {val['batches']} batches, {val['seconds']} s, "
          f"{val['clips_per_s']} clips/s, median batch {val['batch_ms_median']} ms, loader wait "
          f"{val['wait_s']} s, peak allocated {val['peak_allocated_bytes']} bytes, acc {val['acc']}, "
          f"confusion {val['confusion']}")
    check(confusion.shape == (4, 4) and int(confusion.sum()) == val_clips == val["clips"],
          f"speed_val: the confusion matrix counts {int(confusion.sum())} clips, not {val_clips}")
    check(Path(SPEED_RUN_DIR, "Metrics.csv").is_file(), "speed_val wrote no Metrics.csv")

    # the linear probe of the speed run's checkpoint, then multi-view
    # inference: no kernel but BN's on either path (OnlyCrop, the inference
    # crop; the probe's BN trains in train mode)
    shutil.rmtree(PROBE_RUN_DIR, ignore_errors=True)
    prb = run_entry_point([], "linear probe + action_infer", PROBE_CONFIG, PROBE_RUN_DIR, PROBE_RUN_OVERRIDES)
    pcfg = one_card_cfg(tconfig, PROBE_CONFIG)
    n_iter = len(prb["iter_s"])
    inf = prb["action_infer"]
    print(f"[run] probe: {n_iter} iterations, losses {[st['loss_cls'] for st in prb['stats']]}, iterations "
          f"{[t * 1e3 for t in prb['iter_s']]} ms, loader wait {[t * 1e3 for t in prb['wait_s']]} ms, "
          f"peak allocated {prb['peak_allocated_bytes']} bytes (all phases), launches {prb['launches']}, "
          f"{prb['seconds']} s with start-up")
    print(f"[run] action_infer: {inf['total']} videos, {inf['views']} views in {inf['batches']} batches, "
          f"{inf['seconds']} s, {inf['views_per_s']} views/s, median batch {inf['batch_ms_median']} ms, "
          f"loader wait {inf['wait_s']} s, peak allocated {inf['peak_allocated_bytes']} bytes, acc {inf['acc']} "
          f"({inf['correct']}/{inf['total']})")
    check(n_iter == PROBE_RUN_VIDEOS // pcfg.DATA.BATCHSIZE_PER_GPU and prb["start_step"] == 0,
          "probe: wrong schedule")
    check(all(math.isfinite(v) for st in prb["stats"] for v in st.values()), "probe: a loss is not finite")
    check(inf["total"] == PROBE_RUN_VIDEOS and inf["views"] == PROBE_RUN_VIDEOS * 30,
          "action_infer did not see every view of every video")
    check(not any(but_bn(prb["launches"]).values()), "the probe run launched a kernel other than BN's")
    pretrained = torch.load(Path(SPEED_RUN_DIR) / "checkpoints" / "Model_Epoch_0000" / STATE_FILE,
                            map_location="cpu", weights_only=False)["model"]
    probed = torch.load(Path(PROBE_RUN_DIR) / "checkpoints" / "Model_Epoch_0000" / STATE_FILE,
                        map_location="cpu", weights_only=False)["model"]
    fresh = build_model(pcfg, "cpu", seed=pcfg.TRAIN.SEED).state_dict()
    frozen = [k for k in probed if "head" not in k and "running_" not in k]
    head = [k for k in probed if "head" in k]
    stats_moved = sum(not torch.equal(probed[k], pretrained[k]) for k in probed if "running_" in k)
    print(f"[run] probe: {len(frozen)} non-head parameters, {len(head)} head tensors, "
          f"{stats_moved} BN buffers moved by the probe's train mode")
    check(all(torch.equal(probed[k], pretrained[k]) for k in frozen),
          "the probe's frozen parameters differ from the speed checkpoint")
    check(any(not torch.equal(probed[k], fresh[k]) for k in head), "the probe's head did not train")

    # AdViSe through the entry point: the TemporalModelingSampler's ingest at
    # 320x256, the XLA simple aug, the twins in the checkpoint
    shutil.rmtree(ADVISE_RUN_DIR, ignore_errors=True)
    adv = run_entry_point(["TPU.PROFILE_DIR", f"{ADVISE_RUN_DIR}/profile", "TPU.PROFILE_START", "0",
                           "TPU.PROFILE_STEPS", "1"], "AdViSe preset (SSL.TASK speed_byol), 1 epoch",
                          ADVISE_CONFIG, ADVISE_RUN_DIR, ADVISE_RUN_OVERRIDES)
    n_iter = len(adv["iter_s"])
    print(f"[run] AdViSe preset: {n_iter} iterations, stats {adv['stats']}, iterations "
          f"{[t * 1e3 for t in adv['iter_s']]} ms, loader wait {[t * 1e3 for t in adv['wait_s']]} ms, peak "
          f"allocated {adv['peak_allocated_bytes']} bytes, launches {adv['launches']}, {adv['seconds']} s "
          f"with start-up")
    split = {stage: f"{s * 1e3 / n} ms x {n} ({s * 1e3} ms in all)" for stage, (s, n) in adv["host_s"].items()}
    print(f"[run] AdViSe preset: host stages {split}")
    check(n_iter == ADVISE_RUN_VIDEOS // acfg.DATA.BATCHSIZE_PER_GPU and adv["start_step"] == 0,
          "AdViSe preset: wrong schedule")
    check(all(math.isfinite(v) for st in adv["stats"] for v in st.values()), "AdViSe preset: a loss is not finite")
    saved = torch.load(Path(ADVISE_RUN_DIR) / "checkpoints" / "Model_Epoch_0000" / STATE_FILE, map_location="cpu",
                       weights_only=False)
    check(set(saved["ssl"]) == {"ema_temporal", "ema_projector"} and saved["step"] == n_iter,
          "AdViSe preset: the checkpoint lacks the BYOL twins")
    prof = adv.get("profile")
    check(prof is not None, "the AdViSe run's profile window did not close")
    print(f"[run] AdViSe preset profile window ({prof['steps']} iteration): wall {prof['wall_ms']} ms, device "
          f"busy {prof['busy_ms']} ms, idle share {prof['idle_share']}")
    x3d_entry(tconfig)
    moco_entry(tconfig)
    moco_entry(tconfig, "Swin-B MoCo", SWIN_CONFIG, SWIN_RUN_DIR, SWIN_RUN_OVERRIDES, SWIN_RUN_VIDEOS)
    advise_swin_entry(tconfig)
    mae_entry(tconfig)
    maskfeat_entries(tconfig)
    contrastive_entries(tconfig)
    t_new = time.perf_counter()
    host_aug_entries(tconfig)
    mvit_entries(tconfig)
    print(f"[run] phase 8's host-aug and MViT runs {time.perf_counter() - t_new} s")
    t_remote = time.perf_counter()
    for name, n in remote_entries(tconfig).items():
        launches[name] += n
    print(f"[run] phase 8's remote-storage run {time.perf_counter() - t_remote} s")

    print(f"[phase] 9 starts at {time.perf_counter() - t_start} s")
    # -- 9. MViT-L through the entry point -----------------------------------------
    t9 = time.perf_counter()
    mvit_l_entry(tconfig)
    print(f"[run] phase 9 {time.perf_counter() - t9} s")

    print(f"[phase] 10 starts at {time.perf_counter() - t_start} s")
    # -- 10. data parallel: two gloo ranks on the card, SyncBN across them,
    # one NCCL rank ---------------------------------------------------------------
    dp_entries(tconfig)

    print(f"[phase] 11 starts at {time.perf_counter() - t_start} s")
    # -- 11. the model-parallel layouts: two gloo ranks on the card ---------------
    mp_launches, mp_errs = mp_entries(k4_checked)
    for name, n in mp_launches.items():
        launches[name] += n
    for name, err in mp_errs.items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    print(f"[total] chip_smoke.py wall time {time.perf_counter() - t_start} s")

    launches.update(probe_launches)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound"][0], "bound_by": results[name]["bound"][1],
         "library_ms": results[name]["library_ms"]}
        for name, source, replaces in (
            ("stem_conv_fwd", "advise_tpu_torch/csrc/stem_conv.cu",
             "advise_tpu/ops/pallas/stem_conv.py:99"),
            ("stem_conv_wgrad", "advise_tpu_torch/csrc/stem_conv.cu",
             "advise_tpu/ops/pallas/stem_conv.py:126"),
            ("stem_conv_fwd_chunked", "advise_tpu_torch/csrc/stem_conv.cu",
             "advise_tpu/ops/pallas/stem_conv.py:322"),
            ("stem_conv_wgrad_chunked", "advise_tpu_torch/csrc/stem_conv.cu",
             "advise_tpu/ops/pallas/stem_conv.py:322"),
            ("stem_conv_wgrad_only", "advise_tpu_torch/csrc/stem_conv.cu",
             "advise_tpu/ops/pallas/stem_conv.py:353"),
            ("fused_simple_aug", "advise_tpu_torch/csrc/fused_aug.cu",
             "advise_tpu/ops/pallas/fused_aug.py:57"),
            ("flash_mha_fwd", "advise_tpu_torch/csrc/flash_attention.cu",
             "advise_tpu/ops/flash_attention.py:75"),
            ("flash_mha_bwd", "advise_tpu_torch/csrc/flash_attention.cu",
             "advise_tpu/ops/flash_attention.py:75"),
            ("flash_f32_fwd", "advise_tpu_torch/csrc/flash_attention_f32.cu",
             "advise_tpu/ops/flash_attention.py:75"),
            ("flash_f32_bwd", "advise_tpu_torch/csrc/flash_attention_f32.cu",
             "advise_tpu/ops/flash_attention.py:75"),
            ("bn_forward", "advise_tpu_torch/csrc/batch_norm.cu",
             "none: XLA fuses advise_tpu/models/layers/norm.py's chain"),
            ("bn_backward", "advise_tpu_torch/csrc/batch_norm.cu",
             "none: XLA fuses advise_tpu/models/layers/norm.py's chain"),
            *((name, "advise_tpu_torch/csrc/window_probe.cu", f"scripts/probe_mosaic_aot.py:{line}")
              for name, line in PROBE_LINES.items()))
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--syncbn-check"]:
        syncbn_rank()
    elif sys.argv[1:] == ["--nccl-shared-card"]:
        nccl_shared_card_rank()
    elif sys.argv[1:] == ["--model-parallel"]:
        mp_rank()
    else:
        main()
