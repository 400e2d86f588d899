#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lvc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # from the root of the repository
    python3 chip_smoke.py --phases 36-39   # the build and phases 36-39 only

``--phases`` takes numbers, ranges or phase function names (comma
separated); a phase that needs another's run (REQUIRES) brings it along, and
a checkpoint an unselected phase would have written (HANDOFFS) is a
damped-init stand-in. Each phase prints its seconds.

Phases, each of which raises (non-zero exit) on failure:
1. build every kernel source with nvcc for sm_90a, all in parallel;
2. kernel phase: each RoIAlign kernel and its plain PyTorch version on the
   same seeded inputs at the serving path's shapes (p2-p5 of an 8x832x1344
   batch, C=256, bf16, 1000 boxes per image), and the paired kernel again at
   the training path's 512 boxes per image: error, times, bound, and the
   feature bytes a per-box design fetches beside the bound's;
3. reference check: a narrow R-50-FPN at float32 on a small input, on the
   card (kernels) and on the CPU (plain versions), for the band and paired
   pools; proposals and detections must agree;
4. main path: R-101-FPN at full width, 832x1344, bf16, POOLER_IMPL
   pallas_fast, B=8, seeded damped weights, 1 warm-up + 3 timed forwards,
   with every kernel count set to 0 just before and read just after; then
   one B=2 POOLER_IMPL=auto forward, which takes the paired kernel;
5. backward kernel phase: the RoIAlign backward kernel (K3) and its plain
   version at the training path's shapes (p2-p5 of 8x832x1344, C=256, bf16,
   512 boxes per image): error of the bf16 gradients against the sum of
   absolute contributions, two calls bit-equal, float32 on 64 boxes bit-equal
   to the plain version on the CPU, the whole backward's time against two
   bounds, and its peak memory;
6. training reference check: one train step of a narrow R-50-FPN at float32
   (POOLER_IMPL pallas_train, exhaustive sampling) on the card (K2 forward,
   K3 backward) and on the CPU (plain versions) from the same weights;
   losses and every parameter gradient must agree;
7. training main path: the R-50-FPN train step at full width, bf16 AMP,
   POOLER_IMPL pallas_train, B=8 at 832x1344 with 100 gt slots, seeded damped
   weights, 1 warm-up + 5 timed steps with every kernel count set to 0 just
   before and read just after; one profiled step with the device time of
   each stage (the profiler ranges of the step and the model's forward);
8. attention kernel phase: the flash-attention kernel and its plain version
   on the same seeded qkv at the verifier's shape (B, N, H, d) =
   (64, 785, 6, 64), float32 and bf16: error (also on a peaked qkv whose
   logits span tens), card ms (beside the time before this kernel's
   redesign), plain ms, the bound, and scaled_dot_product_attention's ms on
   the same tensors as a yardstick;
9. verify reference check: a narrow ViT (N = 197) at float32 on the card and
   on the CPU from the same weights, and knn_vote on the card and the CPU;
10. verify main path: DINO ViT-S/8 at full width, seeded random weights,
   B=64 crops of 224 through DescriptorExtractor.embed_crops, float32 and
   bf16, 1 warm-up + 5 timed calls with the kernel's count set to 0 just
   before and read just after, one profiled call with the device time of the
   ViT's profiler ranges; knn_vote at S=2,400, Q=50,000, D=384, k=10;
11. the verification CLI (run_nearest_neighbours) on the card on a seeded
   mini COCO tree written to a temporary directory;
12. fused kernel phase: the fused residual GEMM kernel and its plain version
   at the seven shapes of the fused calls of the serving path (every
   bottleneck conv3 and the FPN laterals, 8x832x1344), ReLU on and off and a
   ragged M: error in bf16 ulps, card ms (beside the time before this
   kernel's redesign), plain ms, the bound, the wrapper's host µs per call,
   and the unfused Conv2d tail's and torch.matmul's ms beside them;
13. fused reference check: a narrow R-50-FPN at bf16 with
   LVC_TPU_FUSED_RESIDUAL=1 on the card and on the CPU from the same
   weights: FPN outputs, proposals and the kernel's launches (19);
14. fused serving path: phase 4's R-101-FPN with LVC_TPU_FUSED_RESIDUAL=1,
   timed in turns with the unfused form on the same model (unfused, fused,
   fused, unfused; 3 forwards each, 36 fused launches per forward), one
   profiled fused forward, then lvc_tpu_torch.tools.check_fused_serving at
   B=8;
15. fused training path: phase 7's step with LVC_TPU_FUSED_RESIDUAL=1, in
   turns with the unfused step on the same model (5 steps each; 32 fused
   launches per step: 19 forward, 13 recomputed under REMAT), one profiled
   fused step;
16. trainer reference check: DefaultTrainer on a narrow R-50-FPN (float32,
   exhaustive sampling, POOLER_IMPL pallas_train) for 3 iterations on a
   seeded mini COCO tree, then its evaluation, on the card and on the CPU
   from the same weights: losses, metrics.json rows, result rows and AP;
17. the training CLI's main path: lvc_tpu_torch.tools.train_net.main in this
   process on configs/COCO-detection/faster_rcnn_R_50_FPN_base.yaml
   (R-50-FPN, 60 base classes, IMS_PER_BATCH 16 at 832x1344, AMP,
   POOLER_IMPL auto) from a damped-init .pth, 30 iterations with a
   checkpoint every 15, on a seeded COCO tree (48 train and 16 test JPEGs of
   480x640 and 640x480); finite losses, the checkpoints, the final
   evaluation, K2/K3 launches; then --resume to 35 iterations and
   --eval-only from the 30-iteration checkpoint, whose result rows (at least
   100) and AP must be the final evaluation's; ms/iter over every step after
   warm-up and the `time` scalar's median, data_time, one profiled
   iteration, eval ms/img, peak memory, and whether the native image I/O and
   COCOeval were built; last, 10 float32 iterations with TF32 off and with
   PyTorch's default TF32 convolutions, timed;
18. the synthetic-AP gate (lvc_tpu_torch.tools.verify_synthetic_ap): a
   GroupNorm R-50-FPN trained from scratch on drawn shapes, float32 for 450
   iterations and AMP for 400 (the JAX gate's 600, cut for the script's
   time limit); each must pass verify_results (AP50 >= 60); the
   float32 model evaluated again with TF32 convolutions and without, its
   result rows compared.
19. corrector reference check: a narrow cascade UBBR model (3 stages,
   BoxOnlyLayersCascade, POOLER_IMPL pallas) at float32 on the card and on
   the CPU from the same weights: RBG from the same draws, one training
   step's forward and backward from the same sampled slots (stage losses,
   box-head and FPN-output gradients), reg-only inference on seeded
   candidates, and ProposalNetwork's proposals; K2/K3 launches 3/3 per
   training step, 3/0 per reg-only forward;
20. the correct path at full width through the three CLIs on phase 17's
   tree: train_net --eval-only with ProposalNetwork (both proposal
   pickles, AR), train_net_reg on configs/COCO-detection/
   cascade_ubbr_R_50_FPN_base.yaml as it stands (float32, IMS_PER_BATCH 16
   at 832x1344, 30 iterations with checkpoints, then its IoU test) and
   train_net_reg_qe --resume --eval-only on jittered candidates of the test
   split: ms/iter, data_time, peak memory, one profiled iteration, K2/K3
   launches per step and per batch, iou_in/iou_out, correction ms/img; K2
   and K3 on one training step's own inputs (3 stages of 16 x 64 slots,
   float32, C=256) and K2 on one reg-only batch's candidate slots, against
   their plain versions on the same tensors (K2 bit-equal, K3 1e-5 * S);
21. fine-tune reference check: one train step of the ft_all config
   (CosineSimOutputLayers, 80 classes) at narrow widths, float32,
   POOLER_IMPL pallas_train, on the card and on the CPU from the same
   weights, with the backbone frozen and trained: losses and trainable
   gradients; K2/K3 launches 1/0 frozen and 1/1 trained;
22. the LVC chain of scripts/coco_full_run.sh at full width through its twin
   (lvc_tpu_torch.tools.coco_full_run): all 18 steps on the configs as they
   stand (float32, IMS_PER_BATCH 16 at 832x1344), each from the files of the
   steps before it, on a seeded tree of 80 classes with 30-shot files and an
   unlabeled split, from phase 17's and phase 20's checkpoints, 10
   iterations a training run: ms/iter, data_time, peak memory and the K2/K3
   launches of every iteration of the six training runs (1/1, 1/0, 1/0,
   3/3, 3/0, 1/1), extraction ms/img, the relations between the files the
   steps wrote; then K2 and K3 on one more step 18 iteration's own tensors
   (16 x 512 slots, float32, C=256) against their plain versions;
23. data-parallel reference check: one step of phase 19's narrow corrector,
   of a narrow R-50-FPN and of that R-50-FPN as GeneralizedRCNN_Context,
   with and without IMAGES_ONLY (float32, POOLER_IMPL pallas_train, sampling
   not exhaustive, so the per-image generators decide the slots) on a
   global batch of 4, by 2 ranks placed on the one card with
   launch(..., devices=["cuda:0", "cuda:0"]) (gloo: NCCL refuses two ranks
   on one device), by 1 rank of NCCL DDP, and by 1 process without DDP;
   with two cards or more also by 2 NCCL ranks on two cards: losses,
   gradients after the all-reduce, updated parameters and every image's
   sampled slots agree, a toy global_ratio loss has its analytic gradient,
   and K2/K3 launch 1/1 (detector) and 3/3 (cascade) a rank;
24. the data-parallel training CLI: train_net.main through launch with 2
   ranks placed on the one card (gloo) on faster_rcnn_R_50_FPN_base.yaml
   as it stands (IMS_PER_BATCH 16, 8 a rank, 832x1344, AMP) from phase
   17's damped init, 20 iterations with a checkpoint at 10, on phase 17's
   seeded tree, then the sharded evaluation merged on rank 0: finite
   losses, checkpoints and metrics.json from rank 0 alone, result rows and
   AP equal to a 1-process --eval-only from the last checkpoint, K2/K3 1/1
   a rank an iteration; ms/iter, data_time and peak memory a rank (two
   ranks share one card: no scaling number); then sharded_knn_vote at
   S=2,400, Q=50,000, D=384, k=10 over the 2 ranks against knn_vote;
25. extra heads reference check: narrow ParallelStandardROIHeads (80
   classes), CascadeStandardROIHeads, StandardROIHeadsCascadeBBox and the
   C4 Res5ROIHeads (res4, P=14; three batches) at float32, POOLER_IMPL
   pallas_train, on the card and on the CPU from the same weights, both held
   against a float64 witness on the CPU, the card within a limit set by the
   CPU's own distance: one training step's losses and gradients (exhaustive
   sampling), the eval forward's detections (StandardROIHeads with DEBUG:
   DetectionsDebug), the C4 model also with pallas_fast (K1's band form);
   K2/K3 launches per step and per forward; K1, K2 and K3 on the C4 runs'
   own single-level P=14 tensors against their plain versions;
26. the twin-head fine-tune at full width: ckpt_surgery --method
   combine_parallel of phase 17's base checkpoint and the chain's ft_novel
   checkpoint (phase 22), loaded strictly; train_net on
   faster_rcnn_R_50_FPN_base.yaml with ParallelStandardROIHeads, 80
   classes, the all-class splits of phase 17's tree, IMS_PER_BATCH 16 at
   832x1344, AMP, 20 iterations and its evaluation: ms/iter, data_time,
   peak memory, K2/K3 2/2 every iteration, 200 detection slots;
27. R-50-C4 at full width (the defaults' C4 detector: res4 1024 wide,
   Res5ROIHeads, P=14, RPN 6000/1000 at test), 2 images a card at
   832x1344: bf16 serving forwards with pallas_fast (K1) and auto (K2) at
   score threshold 0.001, each keeping detections, train_net with
   pallas_train and AMP for 20 iterations on phase 17's tree
   (K2/K3 1/1 every iteration) and its evaluation; K1, K2 and K3 on the
   path's own tensors against their plain versions, with their times and
   bounds;
28. VOC evaluation of the trained gate model: phase 18's float32 model over
   its 60 held-out images written as a VOC 2007 tree (JPEGs, XML,
   ImageSets/Main/test.txt), the same detections fed to
   PascalVOCDetectionEvaluator, COCOEvaluator and LVISEvaluator: the VOC
   AP50 must pass the gate's verify_results (in (60, 100)), the LVIS AP
   must equal COCO's within 1e-6; both AP50s and their difference;
29. PASCAL VOC at full width, TFA split 1 (ucbdrive/few-shot-object-detection
   configs/PascalVOC-detection/split1/faster_rcnn_R_101_FPN_base1.yaml and
   _ft_all1_1shot.yaml, built on Base-RCNN-FPN.yaml in code: R-101-FPN,
   TFA's train sizes, MIN_SIZE_TEST 800, IMS_PER_BATCH 16, AMP,
   POOLER_IMPL pallas_train) on a seeded VOC tree (VOC2007 and VOC2012 at
   VOC's 500x375 and 375x500, difficult objects, 1-shot lists), run from
   the tree's directory: train_net on the 07+12 base1 splits, --eval-only
   on voc_2007_test_base1, ckpt_surgery --method randinit to 20 classes,
   the 1-shot ft_all1 fine-tune (FREEZE_FEAT) and --eval-only on
   voc_2007_test_all1 (bAP50, nAP50): ms/iter, data_time, idle share, peak
   memory, K2/K3 per iteration, eval ms/img; K2 and K3 on a base step's own
   tensors against their plain versions;
30. LVIS: phase 17's test split rewritten as an LVIS json (every absent
   category negative), train_net --eval-only from phase 17's checkpoint
   with LVISEvaluator and with COCOEvaluator on coco_test_all: equal rows,
   LVIS AP..APl equal to COCO's within 1e-6; APr/APc/APf;
31. the context detector (GeneralizedRCNN_Context through train_net at
   phase 17's width, its evaluation and image_scores; a narrow card-vs-CPU
   step; K2/K3 on the steps' own tensors), PrecomputedProposals (phase 4's
   R-101 model's proposals fed back: equal detections), DefaultPredictor
   (R-101 bf16 on a 500x375 JPEG: equal to the test loader's batch),
   build_crop_exem_loader over RPNEvaluator's pickle into RPNComp (R-50,
   res5, avg; card vs CPU) and the clustering (PCA 384 -> 256 and k-means
   at N = 50,000; card vs CPU assignments away from near-ties).
32. Mask R-CNN serving (detectron2's mask_rcnn_R_50_FPN_1x.yaml on
   Base-RCNN-FPN.yaml, built in code: R-50-FPN, 80 classes, the mask head
   4 x 256 at P=14): bf16, B=8 at 832x1344, score threshold 0.001, 3 timed
   forwards with pallas_fast (K1 twice a forward: boxes at P=7, masks at
   P=14) and with auto (K2 twice); masks (8, 100, 28, 28) in [0, 1]; each
   pool on the forward's own features and detection boxes against its plain
   version, the P=14 one timed against its bound; the evaluator's
   paste_masks_np and RLE on the detections, ms an image;
33. the Mask R-CNN training step through make_train_step at IMS_PER_BATCH 16
   (POOLER_IMPL pallas_train, seeded gt bitmasks at 1/4 of the canvas, up to
   16 objects an image), float32 and AMP, 10 timed steps each (K2 and K3
   twice a step), loss_mask ln 2 at the first step, peak memory; one AMP
   step's pools against their plain versions, the P=14 pair timed;
34. Keypoint R-CNN (keypoint_rcnn_R_50_FPN_1x.yaml: 1 class, smooth-L1 beta
   0.5, 1500 training proposals, the keypoint head 8 x 512 at P=14): the
   same serving and training checks at B=8 with seeded gt keypoints;
   phases 32-34 run with TF32 convolutions (the training CLIs' setting;
   the heads compute in float32);
35. the narrow Mask R-CNN and Keypoint R-CNN on the card and the CPU against
   a float64 witness (losses, gradients, detections, masks, keypoints), and
   segm evaluation from the card's tensors: oracle masks cropped by
   crop_gt_masks on a seeded tree of polygon, RLE and crowd ground truth
   (an AP floor; moved 3 px, an AP range), the narrow model's card rows
   against the CPU's (RLE IoU).
36. RetinaNet (detectron2's retinanet_R_50_FPN_1x.yaml on Base-RetinaNet.yaml,
   built in code: R-50, p3-p7 with P6/P7 from res5, 9 anchors a location,
   towers 4 x 256, 80 classes): bf16 serving at B=8 on 832x1344 from damped
   weights with the head at its prior, at the yaml's score threshold 0.05
   (which keeps nothing: every score sits at 0.01) and at 0 (1,000
   candidates a level reach the NMS), 3 timed forwards each; then
   train_net.main on it (60 classes: phase 17's tree holds the base
   classes), IMS_PER_BATCH 16, AMP, 10 iterations and the COCO evaluation:
   ms/iter, data_time, peak memory, the first loss_cls within 2% of the
   focal loss the prior predicts for that batch's labels; no TPU kernel;
37. Panoptic FPN (panoptic_fpn_R_50_1x.yaml on Base-Panoptic-FPN.yaml: Mask
   R-CNN R-50-FPN, 80 classes, plus the semantic head, 54 classes, GN,
   128 wide): bf16 serving at B=8 with pallas_fast (K1 twice a forward) and
   auto (K2 twice), each pool on the forward's own tensors against its plain
   version; on the host paste_masks_np and the panoptic fusion of each image
   and PQ of the result against itself (100); AMP training at B=16 with
   seeded gt masks and sem_seg maps (K2/K3 twice a step), loss_mask ln 2
   and loss_sem_seg 0.5 ln 54 at the first step, its pools against their
   plain versions and the P=14 pair timed against its bound;
38. the semantic FPN (Misc/semantic_R_50_FPN_1x.yaml): bf16 serving at B=8,
   10 AMP training steps at B=16 (loss_sem_seg ln 54 at the first), and
   SemSegEvaluator's mIoU of the card's predictions of its own batch;
   phases 36-38 run with TF32 convolutions;
39. the narrow RetinaNet, semantic FPN and Panoptic FPN on the card and the
   CPU against float64 witnesses (losses, gradients, detections, masks,
   semantic logits), and a seeded Cityscapes tree of 1024x2048 frames
   through the port's loaders and both Cityscapes evaluators from the
   card's tensors: oracle boxes AP 100, moved 3 px an AP range, oracle maps
   mIoU 100.
40. Swin-T FPN Faster R-CNN (Base-RCNN-FPN.yaml with
   build_swin_transformer_fpn_backbone, SWIN_SIZE tiny): bf16 serving at
   B=8 with pallas_fast (K1) and auto (K2), each pool on the forward's own
   tensors against its plain version; train_net AMP at IMS_PER_BATCH 16 on
   phase 17's tree, 10 iterations, ms/iter, data_time and peak memory, one
   more step's K2/K3 against their plain versions;
41. ResNet-D in LVC's retrain: train_net_qe_ig on the ft_all dropout config
   with MODEL.RESNETS.D, the CLIP optimizer, AMP, 10 iterations on a chain
   tree with a pseudo-annotation file; one more step's K2/K3 against their
   plain versions; on the card the CLIP update is CLIP_LR / BASE_LR times
   the plain optimizer's; one bf16 serving batch with
   LVC_TPU_FUSED_RESIDUAL=1, every fused GEMM call on its own tensors
   against the plain version;
42. the deformable R-50 (detectron2's mask_rcnn_R_50_FPN_1x_dconv_c3-c5):
   bf16 serving at B=8 and AMP training at B=16 for 10 steps, its peak
   memory, its pools against their plain versions;
43. RROIHeads at full width on a damped R-50-FPN's bf16 p2-p5 of B=8
   832x1344, 2,000 rotated proposals an image: 10 AMP training steps,
   inference with the rotated NMS over 2,048 candidates an image, and
   RotatedCOCOEvaluator on oracle boxes (AP 100) and on them turned 15
   degrees (the AP the boxes' geometry predicts); no TPU kernel;
44. the narrow Swin-FPN, ResNet-D (CLIP optimizer), DCN v1 and v2 detectors
   and narrow RROIHeads on the card and the CPU against float64 witnesses;
45. test-time augmentation: phase 4's R-101-FPN (bf16, POOLER_IMPL auto,
   seeded damped weights) on one seeded 480x640 image at TEST.AUG's nine
   default scales x {identity, flip} = 18 variants, on canvas buckets that
   hold them (TTA_BUCKETS), K2 once a variant; each identity variant equal
   to the plain eval forward on its canvas, the merge on the card equal to
   the same merge on the host; a narrow model's TTA on the card and the CPU
   against a float64 witness; ms an image and the merge's share;
46. export: phase 4's serving forward (R-101-FPN bf16 pallas_fast, B=8 at
   832x1344), DINO ViT-S/8 bf16 at B=64 and one fused GEMM call through
   torch.export, each saved to a .pt2, loaded and run: K1, the attention and
   the fused GEMM launched from the loaded programs, outputs equal to the
   eager calls', export and load seconds, the loaded program's ms against
   the eager forward's.
Phases 1-11 and 16-46 run with the fused path off, whatever the environment
says (spawned ranks inherit it), but for phase 41's fused serving batch.
The last three lines are the kernels' JSON, the card's name and power limit,
and {"ok": true, "device": ...}. Float32 comparisons run with TF32 off for
both convolutions and matmuls (set below).
"""
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_REPLACES = {
    "roi_align_band": "lvc_tpu/ops/roi_align.py:2150; lvc_tpu/ops/roi_align.py:1718; "
                      "lvc_tpu/ops/roi_align.py:1505",
    "roi_align_paired": "lvc_tpu/ops/roi_align.py:1133; lvc_tpu/ops/roi_align.py:2813; "
                        "lvc_tpu/ops/roi_align.py:717",
    "roi_align_paired_bwd": "lvc_tpu/ops/roi_align.py:3174; lvc_tpu/ops/roi_align.py:2340",
    "matmul_affine_residual": "lvc_tpu/ops/fused_matmul.py:76",
}
KERNEL_SOURCE = {
    "roi_align_band": "lvc_tpu_torch/ops/csrc/roi_align_fwd.cu",
    "roi_align_paired": "lvc_tpu_torch/ops/csrc/roi_align_fwd.cu",
    "roi_align_paired_bwd": "lvc_tpu_torch/ops/csrc/roi_align_bwd.cu",
    "matmul_affine_residual": "lvc_tpu_torch/ops/csrc/fused_matmul.cu",
}
HAND_KERNELS = ("roi_align_rows_kernel", "box_ranges_kernel", "roi_align_paired_bwd_kernel",
                "flash_attention_fwd_kernel", "matmul_affine_residual_kernel")
TRAIN_BOXES = 512  # ROI_HEADS.BATCH_SIZE_PER_IMAGE: the sampled boxes per image
MAIN_SHAPES = [(208, 336), (104, 168), (52, 84), (26, 42)]  # p2-p5 of 832x1344
STRIDES = (4, 8, 16, 32)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 100) -> float:
    """The host's microseconds per call of ``fn`` (its enqueue, not the
    card's time): the mean over ``iters`` calls after a synchronised warm-up,
    with no synchronisation in between."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def route_host_us(wrapper, op, *args, rounds: int = 3):
    """The host's microseconds per call of a hand kernel's two routes on the
    same inputs: the wrapper (eager calls, straight to its ``launch``) and
    its custom op through the dispatcher (what an exported program calls,
    landing in the same ``launch``); the least of ``rounds`` alternating
    means of 100 calls each."""
    direct, through_op = [], []
    for _ in range(rounds):
        direct.append(host_us(lambda: wrapper(*args)))
        through_op.append(host_us(lambda: op(*args)))
    return min(direct), min(through_op)


def bf16_ulp(x):
    import torch

    mag = x.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_inputs(dtype, seed: int = 0):
    """Seeded features and boxes at the main path's shapes, with canvas-wide
    boxes (over-wide on p5: the window clamp) and corner-hugging boxes."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, R, C = 8, 1000, 256
    feats = [
        torch.randn(B, C, h, w, generator=g, device="cuda").to(dtype)
        .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for h, w in MAIN_SHAPES
    ]
    xy = torch.rand(B, R, 2, generator=g, device="cuda") * torch.tensor([1344.0, 832.0], device="cuda")
    wh = torch.exp(torch.rand(B, R, 2, generator=g, device="cuda") * 4.3) * 8  # 8 .. ~590 px
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    boxes[..., 0::2] = boxes[..., 0::2].clamp(0, 1344)
    boxes[..., 1::2] = boxes[..., 1::2].clamp(0, 832)
    special = torch.tensor(
        [[0, 0, 1344, 832], [0, 0, 1344, 100], [0, 700, 1344, 832], [1300, 800, 1344, 832],
         [0, 800, 40, 832], [1310, 0, 1344, 30], [0, 0, 20, 20], [600, 400, 600, 400]],
        dtype=torch.float32, device="cuda",
    )
    boxes[:, : len(special)] = special
    return feats, boxes


def touched(level_shapes, taps):
    """The taps the kernels use (rows with a weight, columns with a weight
    inside the level) and the number of distinct feature pixels they touch.
    ``level_shapes`` are the levels' (B, H, W, C)."""
    import torch

    rows_ok = (taps.wy != 0) & (taps.rows >= 0)  # (n, P, NR)
    pixels = 0
    cols_ok_all = torch.zeros(taps.wx.shape, dtype=torch.bool, device=taps.wx.device)
    for l, (B, H, W, _) in enumerate(level_shapes):
        sel = taps.lvl == l
        cols = taps.xs[:, None, None].long() + taps.tcol.long()
        cols_ok = (taps.wx != 0) & (cols < W)
        cols_ok_all |= cols_ok & sel[:, None, None]
        r = torch.where(rows_ok & sel[:, None, None], taps.rows.long(), -1)  # (n, Py, NR)
        c = torch.where(cols_ok & sel[:, None, None], cols, -1)  # (n, Px, NT)
        lin = r[:, :, :, None, None] * W + c[:, None, None, :, :]
        ok = (r[:, :, :, None, None] >= 0) & (c[:, None, None, :, :] >= 0)
        mark = torch.zeros(B * H * W, dtype=torch.bool, device=taps.wx.device)
        mark[lin[ok]] = True
        pixels += int(mark.sum())
    return rows_ok, cols_ok_all, pixels


def box_pixels(level_shapes, taps):
    """The feature pixels a design that reads each box's window once must
    fetch: the sum over boxes of distinct valid rows x distinct valid columns
    (``bound`` counts the union over all boxes instead)."""
    import torch

    widths = torch.tensor([w for _, _, w, _ in level_shapes], device=taps.xs.device)[taps.lvl.long()]
    n = taps.lvl.numel()
    r = torch.where((taps.wy != 0) & (taps.rows >= 0), taps.rows, -1).reshape(n, -1)
    c = taps.xs[:, None, None] + taps.tcol
    c = torch.where((taps.wx != 0) & (c >= 0) & (c < widths[:, None, None]), c, -1).reshape(n, -1)

    def distinct(v):
        v = v.sort(dim=1).values
        return ((v[:, 1:] != v[:, :-1]) & (v[:, 1:] >= 0)).sum(1) + (v[:, 0] >= 0)

    return int((distinct(r) * distinct(c)).sum())


def _roofline(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def bound(feats, taps):
    """Least time for the card: bytes (each feature element the samples touch
    read once, the kernel's other inputs read once, the output written once)
    over the memory rate, against this data's multiply-adds over the float32
    rate. Counts what these inputs need (zero-weight and padding reads are
    not counted)."""
    n, P, NR = taps.rows.shape
    C, isz = feats[0].shape[-1], feats[0].element_size()
    rows_ok, cols_ok, pixels = touched([tuple(f.shape) for f in feats], taps)
    out_bytes = n * P * P * C * isz
    meta_bytes = sum(t.numel() * t.element_size() for t in taps)
    nbytes = pixels * C * isz + out_bytes + meta_bytes
    nr = rows_ok.sum(-1)  # nonzero rows per (n, py)
    nt = cols_ok.sum(-1)  # nonzero taps per (n, px)
    ops = C * int((nt[:, None, :] * (2 * nr[:, :, None] + 2) + 1).sum())
    return _roofline(nbytes, ops)


def backward_bound(level_shapes, taps, gout, dense=True):
    """Least time for K3's function (d pooled -> d features): gout and the
    taps read once and the gradient written once, over the memory rate,
    against this data's operations over the float32 rate (per channel: the
    1/count scale of each output cell, and a multiply and an add for each
    nonzero row-column tap pair). ``dense``: the whole gradient in gout's
    dtype, untouched pixels included, which is what the wrapper returns;
    otherwise only the elements the taps touch, in float32 (the count before
    the gather form, kept to compare with)."""
    C = gout.shape[-1]
    rows_ok, cols_ok, pixels = touched(level_shapes, taps)
    meta_bytes = sum(t.numel() * t.element_size() for t in taps)
    if dense:
        out_bytes = sum(math.prod(s) for s in level_shapes) * gout.element_size()
    else:
        out_bytes = pixels * C * 4
    nbytes = gout.numel() * gout.element_size() + meta_bytes + out_bytes
    nr = rows_ok.sum(-1)
    nt = cols_ok.sum(-1)
    ops = C * int((nt[:, None, :] * 2 * nr[:, :, None] + 1).sum())
    return _roofline(nbytes, ops)


def kernel_phase(tag):
    import torch

    from lvc_tpu_torch.ops import roi_align as ra

    feats, boxes = kernel_inputs(torch.bfloat16)
    shapes = [tuple(f.shape[1:3]) for f in feats]
    B = boxes.shape[0]
    train_boxes = boxes[:, :TRAIN_BOXES].contiguous()
    cases = {
        "roi_align_band": (ra.roi_align_band, ra.band_taps(
            ra.tiled_prep_band(shapes, B, boxes, STRIDES, dtype=torch.bfloat16), shapes, B, 32, True)),
        "roi_align_paired": (ra.roi_align_paired, ra.paired_taps(
            ra.tiled_prep_2d(shapes, B, boxes, STRIDES, dtype=torch.bfloat16), shapes, 48)),
        # the training pool's forward: the same kernel at 512 boxes per image
        "roi_align_paired@train": (ra.roi_align_paired, ra.paired_taps(
            ra.tiled_prep_2d(shapes, B, train_boxes, STRIDES, dtype=torch.bfloat16), shapes, 48)),
    }
    results = {}
    for case, (kernel, taps) in cases.items():
        name = case.split("@")[0]
        got = kernel(feats, taps)
        torch.cuda.synchronize()
        want = ra.roi_align_taps_plain(feats, taps, kernel.paired)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite output")
        err = (got.float() - want.float()).abs()
        # tolerance: one bf16 ulp of the output magnitude, element by element
        tol = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
        if not bool((err <= tol).all()):
            raise AssertionError(f"{name}: max abs err {float(err.max())} over 1 bf16 ulp")
        if not torch.equal(kernel(feats, taps), got):
            raise AssertionError(f"{case}: two calls differ")
        ms = cuda_ms(lambda: kernel(feats, taps), 50)
        plain_ms = cuda_ms(lambda: ra.roi_align_taps_plain(feats, taps, kernel.paired), 3)
        op = getattr(torch.ops.lvc_tpu_torch, kernel.symbol)
        wrapper_us, op_us = route_host_us(lambda *_: kernel(feats, taps), op, list(feats), *taps)
        bound_ms, bound_by, nbytes, ops = bound(feats, taps)
        # feature bytes: the union of the boxes' pixels (in the bound) against
        # the sum of each box's window, what a per-box design fetches from L2
        C, isz = feats[0].shape[-1], feats[0].element_size()
        level_shapes = [tuple(f.shape) for f in feats]
        union = touched(level_shapes, taps)[2] * C * isz
        fetch = box_pixels(level_shapes, taps) * C * isz
        fetch_ms = (nbytes - union + fetch) / HBM_BYTES_PER_S * 1e3
        if "@" not in case:
            results[name] = dict(
                name=name, route="cuda", source=KERNEL_SOURCE[name], replaces=KERNEL_REPLACES[name],
                launches=0, max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, host_us=wrapper_us, op_host_us=op_us,
            )
        print(f"kernel {case}: host us per call, wrapper {wrapper_us:.1f}, custom op {op_us:.1f} {tag}")
        print(f"kernel {case}: boxes {taps.lvl.numel()} max_abs_err {float(err.max())} "
              f"(tolerance 1 bf16 ulp; two calls bit-equal) ms {ms:.4f} plain_ms {plain_ms:.3f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}; {nbytes} bytes, {ops} ops) share "
              f"{bound_ms / ms:.3f}; feature bytes: union {union}, sum of per-box windows {fetch} "
              f"({fetch_ms:.4f} ms with them at the memory rate, share {fetch_ms / ms:.3f}) {tag}")
    # the float32 instantiations, which a SyncBN model's float32 FPN levels take in its bf16 forward (phase 47)
    feats, boxes = kernel_inputs(torch.float32)
    rec = PoolRecorder()
    rec.band = [(feats, ra.band_taps(ra.tiled_prep_band(shapes, B, boxes, STRIDES), shapes, B, 32, True))]
    rec.fwd = [(feats, ra.paired_taps(ra.tiled_prep_2d(shapes, B, boxes, STRIDES), shapes, 48))]
    check_recorded_pool("kernel float32 (K1 and K2 at the serving shapes, 8 x 1000 boxes)", rec, tag, timed=True)
    return results


def calibrated_init(model, seed: int):
    """He-normal weights scaled to keep a narrow detector's outputs well
    spread (FPN features O(10), RPN logits std ~1-2, class scores in
    (0.05, 0.5)): the reference check then has no near-ties to flip."""
    import math

    import torch

    gen = torch.Generator().manual_seed(seed)
    scale = {
        "backbone.bottom_up.": 0.7, "proposal_generator.rpn_head.conv.": 0.1,
        "proposal_generator.rpn_head.objectness_logits.": 0.1,
        "proposal_generator.rpn_head.anchor_deltas.": 0.01,
        "roi_heads.box_predictor.cls_score.": 0.03, "roi_heads.box_predictor.bbox_pred.": 0.3,
        # RetinaNet's head: logits about the prior's with std ~1 (a few percent of the scores above 0.05), deltas
        # O(0.3)
        "head.cls_subnet.": 0.5, "head.bbox_subnet.": 0.5, "head.cls_score.": 0.05, "head.bbox_pred.": 0.015,
    }
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("bias", "running_mean")):
                t.zero_()
            elif name.endswith(("running_var", ".scale")) or ".norm." in name or t.dim() == 1:
                t.fill_(1.0)  # the cosine head's learnable scale starts at 1, as he_init starts it; LayerNorm weights
            else:
                std = math.sqrt(2.0 / (t.shape[0] * t[0, 0].numel())) if t.dim() == 4 else math.sqrt(1.0 / t.shape[1])
                f = next((v for k, v in scale.items() if name.startswith(k)), 1.0)
                t.copy_(torch.randn(t.shape, generator=gen) * std * f)


def narrow_cfg(impl: str):
    """A narrow R-50-FPN (64-wide res2 and FPN, 5 classes) for the reference
    checks."""
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = impl
    return cfg


def reference_check(tag):
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model

    rng = np.random.RandomState(3)
    batch = {
        "image": (rng.rand(2, 128, 192, 3) * 255).astype(np.float32),
        "image_size": np.array([[128, 192], [112, 160]], np.int32),
    }
    for impl in ("pallas_fast", "pallas"):
        cfg = narrow_cfg(impl)
        cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
        cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
        cfg.TEST.DETECTIONS_PER_IMAGE = 30
        cpu = build_model(cfg, device="cpu")
        calibrated_init(cpu, seed=0)
        gpu = build_model(cfg)
        gpu.load_state_dict(cpu.state_dict())
        out = {}
        for key, model in (("cpu", cpu), ("gpu", gpu)):
            props = model.proposals(batch)
            dets = model(batch)
            out[key] = [t.cpu() for t in props] + [t.cpu() for t in dets[:5]]
        c, g = out["cpu"], out["gpu"]
        if not torch.equal(c[2], g[2]) or int(c[2].sum()) < 50:
            raise AssertionError(f"{impl}: proposal validity differs or too few proposals")
        prop_err = float((c[0] - g[0]).abs().max())
        dv = c[6]
        if not torch.equal(dv, g[6]) or int(dv.sum()) < 10 or not torch.equal(c[5][dv], g[5][dv]):
            raise AssertionError(f"{impl}: detections differ in validity or class")
        box_err = float((c[3][dv] - g[3][dv]).abs().max())
        score_err = float((c[4][dv] - g[4][dv]).abs().max())
        if prop_err > 1e-3 or box_err > 1e-3 or score_err > 1e-4:
            raise AssertionError(f"{impl}: errors {prop_err} {box_err} {score_err}")
        print(f"reference {impl}: card vs CPU at float32, {int(c[2].sum())} proposals max err "
              f"{prop_err:.2e} (tol 1e-3), {int(dv.sum())} detections box err {box_err:.2e} "
              f"(tol 1e-3) score err {score_err:.2e} (tol 1e-4) {tag}")


def serving_cfg(impl: str):
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.DEPTH = 101
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = impl
    cfg.MODEL.RPN.APPROX_TOPK = True  # the port maps it to the exact top-k
    return cfg


def main_path(tag, kernels):
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.utils.init import damped_init

    wrappers = {"roi_align_band": ra.roi_align_band, "roi_align_paired": ra.roi_align_paired}
    model = damped_init(build_model(serving_cfg("pallas_fast")), seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, W = 8, 832, 1344
    batch = {
        "image": torch.rand(B, H, W, 3, generator=g, device="cuda") * 255,
        "image_size": torch.tensor([[H, W]] * B, dtype=torch.int32, device="cuda"),
    }
    dets = model(batch)  # warm-up
    torch.cuda.synchronize()

    for w in wrappers.values():
        w.launches = 0
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        dets = model(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    counts = {k: w.launches for k, w in wrappers.items()}
    kernels["roi_align_band"]["launches"] = counts["roi_align_band"]
    if counts["roi_align_band"] < iters:
        raise AssertionError(f"main path did not go through the band kernel: {counts}")
    check_detections(dets, B)
    print(f"main path R-101-FPN 832x1344 bf16 pallas_fast B={B}: {ms:.2f} ms/batch "
          f"{B * 1e3 / ms:.2f} img/s, launches {counts}, valid detections "
          f"{int(dets.valid.sum())} {tag}")

    # stage breakdown of one forward (host clock around synchronised stages)
    with torch.no_grad():
        marks = [time.perf_counter()]
        feats = model.backbone(model.model_images(batch)); torch.cuda.synchronize(); marks.append(time.perf_counter())
        sizes = batch["image_size"]
        props, _, pvalid, _ = model.proposal_generator(feats, sizes); torch.cuda.synchronize(); marks.append(time.perf_counter())
        pooled = model.roi_heads.pool(feats, props); torch.cuda.synchronize(); marks.append(time.perf_counter())
        model.roi_heads(feats, props, pvalid, sizes); torch.cuda.synchronize(); marks.append(time.perf_counter())
    stages = ["backbone", "rpn", "pool", "roi_heads(pool+head+inference)"]
    print("main path stages ms: " + ", ".join(
        f"{s} {(marks[i + 1] - marks[i]) * 1e3:.2f}" for i, s in enumerate(stages)) + f" {tag}")
    profile_call(lambda: model(batch), ms, "forward", tag)
    del model, feats, props, pooled
    torch.cuda.empty_cache()

    # second path: POOLER_IMPL auto takes the paired kernel on CUDA
    model = damped_init(build_model(serving_cfg("auto")), seed=0)
    small = {"image": batch["image"][:2], "image_size": batch["image_size"][:2]}
    for w in wrappers.values():
        w.launches = 0
    dets = model(small)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    kernels["roi_align_paired"]["launches"] = counts["roi_align_paired"]
    if counts["roi_align_paired"] < 1:
        raise AssertionError(f"auto path did not go through the paired kernel: {counts}")
    check_detections(dets, 2)
    print(f"auto path R-101-FPN 832x1344 bf16 B=2: launches {counts} {tag}")
    return ms


def profile_call(fn, untraced_ms, what, tag, stages=()):
    """One call of ``fn`` (a forward or a train step) under torch.profiler:
    the device's busy time (union of kernel intervals), its idle share of the
    traced device span and of the untraced call's time (the profiler slows
    the host, so the traced share overstates idling), the device time of the
    profiler ranges named in ``stages``, the device time of the hand-written
    kernels, and the ops that take the most device time. Prints "not
    measured" if the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity, less the device-side spans the profiler draws for each
    # record_function range (they cover the range, busy or not)
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.name not in stages
    )
    if not spans:
        print(f"profile: no device activity recorded; idle share not measured {tag}")
        return
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    print(f"profile: traced {what} {wall_ms:.2f} ms wall, device span {span / 1e3:.2f} ms, busy "
          f"{busy / 1e3:.2f} ms, idle share {1 - busy / span:.3f} of the traced span, "
          f"{1 - busy / 1e3 / untraced_ms:.3f} of the untraced {untraced_ms:.2f} ms {tag}")
    if stages:
        stage_times(prof.events(), stages, tag)
    # the hand-written kernels, launched through ctypes, are linked to no torch
    # op, so neither the stage ranges nor the op table below count them
    hand = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = next((k for k in HAND_KERNELS if k in e.name), None)
            if name:
                t, n = hand.get(name, (0.0, 0))
                hand[name] = (t + e.time_range.end - e.time_range.start, n + 1)
    print("hand-written kernels, device ms: " + (", ".join(
        f"{k} {t / 1e3:.3f} (x{n})" for k, (t, n) in sorted(hand.items())) or "none") + f" {tag}")
    # device time attributed to the host-side ops that launched it
    rows = [
        (a.self_device_time_total, a.count, a.key)
        for a in prof.key_averages()
        if a.device_type == DeviceType.CPU and a.self_device_time_total > 0
    ]
    for t, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {t / 1e3:8.3f} ms device  x{count:<5d} {key[:80]} {tag}")


def backward_kernel_phase(tag):
    """K3 and its plain version at the training path's shapes. K3 returns
    the gradients in gout's dtype (bf16 here); each element must be within 1
    bf16 ulp of the plain version's float32 sum cast to bf16, plus 1e-5 * S,
    S the plain backward on |gout| and |weights| (the plain version on the
    card adds with index_add_'s atomics, in no fixed order; where a sum
    cancels to near 0 its ulp is below that float32 error; the count of such
    elements is printed). Two calls must give the same bits, and at float32
    on the first 64 boxes K3 must equal the plain version run on the CPU bit
    for bit (it sums in that order). Times the whole backward (gout to
    feature-dtype gradients) and prints its share of two bounds and its peak
    memory."""
    import torch

    from lvc_tpu_torch.ops import roi_align as ra

    feats, boxes = kernel_inputs(torch.bfloat16)
    boxes = boxes[:, :TRAIN_BOXES].contiguous()
    shapes = [tuple(f.shape[1:3]) for f in feats]
    level_shapes = [tuple(f.shape) for f in feats]
    B, C = boxes.shape[0], feats[0].shape[-1]
    taps = ra.paired_taps(ra.tiled_prep_2d(shapes, B, boxes, STRIDES, dtype=torch.bfloat16), shapes, 48)
    n, P, _ = taps.rows.shape
    g = torch.Generator(device="cuda").manual_seed(1)
    gout = torch.randn(n, P, P, C, generator=g, device="cuda").to(torch.bfloat16)
    del feats

    k3 = ra.roi_align_paired_bwd
    got = k3(level_shapes, taps, gout)
    torch.cuda.synchronize()
    if any(a.dtype != gout.dtype or tuple(a.shape) != s for a, s in zip(got, level_shapes)):
        raise AssertionError("roi_align_paired_bwd: wrong dtype or shape")
    again = k3(level_shapes, taps, gout)
    if not all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(got, again)):
        raise AssertionError("roi_align_paired_bwd: two calls differ")
    del again
    want = ra.roi_align_taps_plain_backward(level_shapes, taps, gout)
    S = ra.roi_align_taps_plain_backward(
        level_shapes, taps._replace(wy=taps.wy.abs(), wx=taps.wx.abs()), gout.abs()
    )
    max_err, max_ratio, over_ulp = 0.0, 0.0, 0
    for l, (a, w, s) in enumerate(zip(got, want, S)):
        ref = w.to(torch.bfloat16).float()
        err = (a.float() - ref).abs()
        if not torch.isfinite(a).all() or not bool((err <= bf16_ulp(ref) + 1e-5 * s).all()):
            raise AssertionError(f"roi_align_paired_bwd level {l}: over 1 bf16 ulp + 1e-5 * S")
        over_ulp += int((err > bf16_ulp(ref)).sum())
        max_err = max(max_err, float(err.max()))
        max_ratio = max(max_ratio, float((err / s.clamp(min=1e-30)).max()))
    del want, S

    # float32, the first 64 boxes: bit-equal to the plain version on the CPU
    sub = ra.RoiTaps(*[t[:64].contiguous() for t in taps])
    g32 = torch.randn(64, P, P, C, generator=g, device="cuda")
    card = k3(level_shapes, sub, g32)
    cpu = ra.roi_align_taps_plain_backward(level_shapes, ra.RoiTaps(*[t.cpu() for t in sub]), g32.cpu())
    if not all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)) for a, b in zip(card, cpu)):
        raise AssertionError("roi_align_paired_bwd: float32 result differs from the CPU plain version")
    del card, cpu

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k3(level_shapes, taps, gout)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(lambda: k3(level_shapes, taps, gout), 50)
    plain_ms = cuda_ms(lambda: ra.roi_align_taps_plain_backward(level_shapes, taps, gout), 3)
    bound_ms, bound_by, nbytes, ops = backward_bound(level_shapes, taps, gout)
    touched_ms, _, touched_bytes, _ = backward_bound(level_shapes, taps, gout, dense=False)
    fetch = box_pixels(level_shapes, taps) * C * gout.element_size()
    print(f"kernel roi_align_paired_bwd: boxes {n} max_abs_err {max_err} (bf16 output) max err/S "
          f"{max_ratio:.3e} (tolerance 1 bf16 ulp of the plain version's cast + 1e-5 * S, {over_ulp} "
          f"elements over 1 ulp alone; two calls bit-equal; float32 on 64 boxes bit-equal to the CPU "
          f"plain version) whole backward ms {ms:.4f} plain_ms {plain_ms:.3f} "
          f"bound_ms {bound_ms:.4f} (dense {gout.dtype} gradient written once; {bound_by}; {nbytes} "
          f"bytes, {ops} ops) share {bound_ms / ms:.3f}; touched-f32 bound_ms {touched_ms:.4f} "
          f"({touched_bytes} bytes) share {touched_ms / ms:.3f}; peak memory of one call "
          f"{peak / 2 ** 20:.1f} MiB over the {base / 2 ** 20:.1f} MiB live before it; "
          f"the train forward's per-box window fetch {fetch} bytes {tag}")
    return dict(
        name="roi_align_paired_bwd", route="cuda", source=KERNEL_SOURCE["roi_align_paired_bwd"],
        replaces=KERNEL_REPLACES["roi_align_paired_bwd"], launches=0, max_abs_err=max_err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )


def train_batch(B, H, W, G, seed, device, num_classes=80, n_gt=(10, 20), size=(16, 600)):
    """Seeded training batch: raw pixels, G gt slots per image of which
    n_gt[0]..n_gt[1] are valid boxes of size[0]..size[1] px inside the image,
    with classes in [0, num_classes)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 4), np.float32)
    classes = np.zeros((B, G), np.int64)
    valid = np.zeros((B, G), bool)
    for b in range(B):
        k = rng.randint(n_gt[0], n_gt[1] + 1)
        wh = rng.uniform(size[0], size[1], (k, 2))
        xy = rng.uniform(0, 1, (k, 2)) * ([W, H] - wh)
        boxes[b, :k] = np.concatenate([xy, xy + wh], -1)
        classes[b, :k] = rng.randint(0, num_classes, k)
        valid[b, :k] = True
    batch = {
        "image": rng.rand(B, H, W, 3).astype(np.float32) * 255,
        "image_size": np.array([[H, W]] * B, np.int32),
        "gt_boxes": boxes, "gt_classes": classes, "gt_valid": valid,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def box_masks(gt_boxes, gt_valid, H: int, W: int, factor: int = 4):
    """Seeded-batch gt bitmasks at 1/``factor`` of the (H, W) canvas, as JAX's
    wiring test feeds them (``tests/test_mask_keypoint_wiring.py:35-67``),
    each the ellipse inscribed in its box: (B, G, H/factor, W/factor) bool,
    on the boxes' device."""
    import torch

    h, w = H // factor, W // factor
    yy = (torch.arange(h, device=gt_boxes.device) + 0.5)[:, None]
    xx = (torch.arange(w, device=gt_boxes.device) + 0.5)[None, :]
    b = gt_boxes.double()[..., None, None] / factor  # (B, G, 4, 1, 1)
    cy, cx = (b[..., 1, :, :] + b[..., 3, :, :]) / 2, (b[..., 0, :, :] + b[..., 2, :, :]) / 2
    ry = ((b[..., 3, :, :] - b[..., 1, :, :]) / 2).clamp(min=0.5)
    rx = ((b[..., 2, :, :] - b[..., 0, :, :]) / 2).clamp(min=0.5)
    inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return inside & gt_valid.bool()[..., None, None]


def box_keypoints(gt_boxes, gt_valid, K: int = 17, seed: int = 0):
    """Seeded gt keypoints (B, G, K, 3): each uniform in its box with
    visibility 0, 1 or 2 (0 for invalid gts), on the boxes' device."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    boxes = gt_boxes.cpu().numpy()
    B, G = boxes.shape[:2]
    kps = np.zeros((B, G, K, 3), np.float32)
    kps[..., 0] = rng.uniform(boxes[..., 0:1], np.maximum(boxes[..., 2:3], boxes[..., 0:1]), (B, G, K))
    kps[..., 1] = rng.uniform(boxes[..., 1:2], np.maximum(boxes[..., 3:4], boxes[..., 1:2]), (B, G, K))
    kps[..., 2] = rng.choice([0, 1, 2], (B, G, K), p=[0.2, 0.3, 0.5]) * gt_valid.cpu().numpy()[..., None]
    return torch.from_numpy(kps).to(gt_boxes.device)


def dense_batch(B, H, W, G, seed, device, num_classes=80, sem_classes=54, n_gt=(4, 16), size=(32, 500)):
    """``train_batch`` for the dense models: image i > 0 of the batch fills
    (1 - i / (8 B)) of the canvas in each axis (its gt boxes clipped to it,
    those left under 8 px dropped), and the batch adds ``sem_seg`` (B, H, W)
    int64, blocks of 32 x 32 px of seeded classes in [0, sem_classes) with
    255 in the padding, and ``gt_masks`` (``box_masks``)."""
    import numpy as np
    import torch

    batch = train_batch(B, H, W, G, seed, device, num_classes, n_gt, size)
    rng = np.random.RandomState(seed + 1)
    sizes = np.array([[round(H * (1 - i / (8 * B))), round(W * (1 - i / (8 * B)))] for i in range(B)], np.int32)
    hw = torch.from_numpy(sizes).to(device).float()
    limit = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)[:, None, :]
    boxes = torch.minimum(batch["gt_boxes"], limit)
    valid = batch["gt_valid"] & ((boxes[..., 2:] - boxes[..., :2]) >= 8).all(-1)
    blocks = rng.randint(0, sem_classes, (B, -(-H // 32), -(-W // 32)))
    sem = np.repeat(np.repeat(blocks, 32, axis=1), 32, axis=2)[:, :H, :W].astype(np.int64)
    rows, cols = np.arange(H)[None, :, None], np.arange(W)[None, None, :]
    sem[(rows >= sizes[:, 0, None, None]) | (cols >= sizes[:, 1, None, None])] = 255
    batch.update(image_size=torch.from_numpy(sizes).to(device), gt_boxes=torch.where(valid[..., None], boxes, 0.0),
                 gt_valid=valid, sem_seg=torch.from_numpy(sem).to(device))
    batch["gt_masks"] = box_masks(batch["gt_boxes"], valid, H, W)
    return batch


CITYSCAPES_THINGS = ("person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle")


def write_cityscapes_tree(root: str, split: str = "val", cities=("aachen", "bremen"), per_city: int = 2,
                          hw=(256, 512), seed: int = 0):
    """A seeded Cityscapes tree in the layout ``data/cityscapes.py`` walks:
    ``leftImg8bit/<split>/<city>/<city>_<seq>_000019_leftImg8bit.png`` and
    beside each under ``gtFine/<split>/<city>/`` its ``_gtFine_polygons.json``
    (``imgHeight``, ``imgWidth`` and objects: 3-8 things as 10-point
    polygons, one in four a ``...group`` crowd, stuff polygons ``road`` and
    ``sky`` that the loader skips, and one degenerate (flat) thing),
    ``_gtFine_labelIds.png`` (uint8: 16 x 16 px blocks of classes 0-18 of the
    19-class space JAX's evaluator counts in, 255 void) and
    ``_gtFine_instanceIds.png`` (uint16, class x 1000 + instance inside each
    thing's box; the loaders do not read it)."""
    import json

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    H, W = hw
    for c, city in enumerate(cities):
        img_dir = os.path.join(root, "leftImg8bit", split, city)
        gt_dir = os.path.join(root, "gtFine", split, city)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        for k in range(per_city):
            prefix = f"{city}_{c * 100 + k:06d}_000019_"
            low = rng.randint(0, 255, (H // 16, W // 16, 3)).astype(np.uint8)
            Image.fromarray(np.kron(low, np.ones((16, 16, 1), np.uint8))).save(
                os.path.join(img_dir, prefix + "leftImg8bit.png"))
            labels = np.kron(rng.randint(0, 19, (H // 16, W // 16)), np.ones((16, 16), np.int64))
            labels[rng.rand(H, W) < 0.05] = 255
            instances = np.zeros((H, W), np.uint16)
            objects = [{"label": "road", "polygon": [[0, H - 1], [W - 1, H - 1], [W - 1, H // 2], [0, H // 2]]},
                       {"label": "sky", "polygon": [[0, 0], [W - 1, 0], [W - 1, 20], [0, 20]]}]
            for j in range(rng.randint(3, 9)):
                cls = int(rng.randint(len(CITYSCAPES_THINGS)))
                bw, bh = rng.uniform(24, W / 3), rng.uniform(24, H / 2)
                x0, y0 = rng.uniform(0, W - bw), rng.uniform(0, H - bh)
                t = np.sort(rng.uniform(0, 2 * np.pi, 10))
                pts = np.stack([x0 + bw / 2 * (1 + np.cos(t)), y0 + bh / 2 * (1 + np.sin(t))], -1)
                label = CITYSCAPES_THINGS[cls] + ("group" if j % 4 == 3 else "")
                objects.append({"label": label, "polygon": np.round(pts, 1).tolist()})
                instances[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = (24 + cls) * 1000 + j
            objects.append({"label": "car", "polygon": [[10.0, 40.0], [60.0, 40.0], [35.0, 40.0]]})
            with open(os.path.join(gt_dir, prefix + "gtFine_polygons.json"), "w") as f:
                json.dump({"imgHeight": H, "imgWidth": W, "objects": objects}, f)
            Image.fromarray(labels.astype(np.uint8)).save(os.path.join(gt_dir, prefix + "gtFine_labelIds.png"))
            Image.fromarray(instances).save(os.path.join(gt_dir, prefix + "gtFine_instanceIds.png"))


def cityscapes_oracle(dicts, device, shift: float = 0.0, D: int = 16):
    """Each image of ``load_cityscapes_instances``'s dicts as
    ``(image_id, (h, w), gt boxes XYXY, gt classes, one image's Detections)``, the
    detections every gt box (crowds included, as the evaluator counts them)
    moved ``shift`` px right and down, scores falling from 0.9, on
    ``device``."""
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections

    out = []
    for d in dicts:
        xywh = np.array([a["bbox"] for a in d["annotations"]], np.float32).reshape(-1, 4)
        boxes = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], -1)
        classes = np.array([a["category_id"] for a in d["annotations"]], np.int64)
        n = len(boxes)
        det_boxes = torch.zeros(D, 4, device=device)
        det_boxes[:n] = torch.from_numpy(boxes + shift).to(device)
        det_cls = torch.zeros(D, dtype=torch.int64, device=device)
        det_cls[:n] = torch.from_numpy(classes).to(device)
        valid = torch.arange(D, device=device) < n
        scores = torch.linspace(0.9, 0.5, D, device=device)
        dets = Detections(det_boxes, scores, det_cls, valid, torch.zeros_like(det_cls))
        out.append((d["image_id"], (d["height"], d["width"]), boxes, classes, dets))
    return out


def narrow_task_heads(cfg, mask: bool = False, keypoint: bool = False):
    """The mask and keypoint heads at the narrow models' widths: 2 convs 32
    wide (the defaults are 4 x 256 and 8 x 512)."""
    cfg.MODEL.MASK_ON, cfg.MODEL.KEYPOINT_ON = mask, keypoint
    for head in (cfg.MODEL.ROI_MASK_HEAD, cfg.MODEL.ROI_KEYPOINT_HEAD):
        head.NUM_CONV, head.CONV_DIM = 2, 32
    return cfg


def train_reference_check(tag):
    """One train step of a narrow R-50-FPN at float32 with POOLER_IMPL
    pallas_train on the card (K2 + K3) and on the CPU (plain versions), from
    the same weights and the same sampling priorities. Sampling is
    exhaustive (RPN 8192 >= the 6138 anchors, ROI 128 >= 100 proposals + 4
    gt): every loss to rel 1e-4, every parameter gradient to rel L2 1e-4."""
    import torch

    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer

    cfg = narrow_cfg("pallas_train")
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192
    cfg.MODEL.RPN.POSITIVE_FRACTION = 0.999
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 128
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.999
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    cpu = build_model(cfg, device="cpu")
    calibrated_init(cpu, seed=0)
    gpu = build_model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    batch = train_batch(2, 128, 192, 4, seed=3, device="cpu", num_classes=5, n_gt=(3, 3), size=(24, 100))
    before = ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches
    res = {}
    for key, model in (("cpu", cpu), ("gpu", gpu)):
        model.train()
        opt = build_optimizer(cfg, model)
        step = make_train_step(model, opt, build_lr_schedule(cfg, opt))
        metrics = step(batch, torch.Generator().manual_seed(0))
        grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters() if p.requires_grad}
        res[key] = {k: float(v) for k, v in metrics.items()}, grads
    torch.cuda.synchronize()
    after = ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches
    if not (after[0] > before[0] and after[1] > before[1]):
        raise AssertionError(f"training reference step did not launch K2 and K3: {before} -> {after}")
    (c_loss, c_grad), (g_loss, g_grad) = res["cpu"], res["gpu"]
    loss_err = max(abs(g_loss[k] - v) / max(abs(v), 1e-30) for k, v in c_loss.items())
    if set(c_loss) != set(g_loss) or loss_err > 1e-4 or c_loss["loss_box_reg"] <= 0:
        raise AssertionError(f"training losses differ: cpu {c_loss} card {g_loss}")
    rel = {n: float((g_grad[n] - w).norm() / w.norm().clamp(min=1e-30)) for n, w in c_grad.items()}
    worst = max(rel, key=rel.get)
    if rel[worst] > 1e-4:
        raise AssertionError(f"training grads differ: {worst} rel L2 {rel[worst]}")
    print(f"train reference pallas_train: card vs CPU at float32, losses {c_loss} max rel err "
          f"{loss_err:.2e} (tol 1e-4); {len(rel)} parameter grads max rel L2 {rel[worst]:.2e} "
          f"({worst}; tol 1e-4); K2/K3 launches +{after[0] - before[0]}/+{after[1] - before[1]} {tag}")


def train_cfg():
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "pallas_train"
    cfg.SOLVER.AMP.ENABLED = True
    cfg.SOLVER.BASE_LR = 1e-4  # random weights
    cfg.SOLVER.WARMUP_ITERS = 0
    return cfg


def train_main_path(tag, kernels):
    import torch

    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer
    from lvc_tpu_torch.utils.init import damped_init

    wrappers = {"roi_align_band": ra.roi_align_band, "roi_align_paired": ra.roi_align_paired,
                "roi_align_paired_bwd": ra.roi_align_paired_bwd}
    cfg = train_cfg()
    model = damped_init(build_model(cfg), seed=0).train()
    opt = build_optimizer(cfg, model)
    sched = build_lr_schedule(cfg, opt)
    step = make_train_step(model, opt, sched, mixed_precision=cfg.SOLVER.AMP.ENABLED)
    B, H, W = 8, 832, 1344
    batch = train_batch(B, H, W, cfg.PAD.MAX_GT_PER_IMAGE, seed=0, device="cuda",
                        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(batch, gen)  # warm-up
    torch.cuda.synchronize()

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = 5
    t0 = time.perf_counter()
    metrics = [step(batch, gen) for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    for k in ("roi_align_paired", "roi_align_paired_bwd"):
        kernels[k]["launches"] += counts[k]
        if counts[k] < steps:
            raise AssertionError(f"train path did not launch {k} once per step: {counts}")
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"non-finite training losses: {losses}")
    print(f"train main path R-50-FPN 832x1344 AMP bf16 pallas_train B={B}: {ms:.2f} ms/step "
          f"{B * 1e3 / ms:.2f} img/s, launches {counts}, peak memory {peak / 2 ** 30:.2f} GiB {tag}")
    for i, m in enumerate(losses):
        print(f"  step {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items())) + f" {tag}")
    profile_call(lambda: step(batch, gen), ms, "train step", tag, TRAIN_STAGES)
    del model, opt
    torch.cuda.empty_cache()
    return ms, peak


# the profiler ranges of GeneralizedRCNN._losses and make_train_step's step
TRAIN_STAGES = ("backbone", "rpn", "roi_heads", "backward", "optimizer")


def stage_times(events, stages, tag):
    """Device time of each profiler range of ``stages``: the kernels of
    every host op that starts inside the range, on any thread (the backward
    runs on autograd's), beside the range's host time. Kernels of ops outside
    every range are "other"."""
    from torch.autograd import DeviceType

    ranges = {s: [] for s in stages}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in ranges:
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    device = dict.fromkeys(list(stages) + ["other"], 0.0)
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        t = e.time_range.start
        where = next((s for s, rs in ranges.items() if any(a <= t <= b for a, b in rs)), "other")
        device[where] += sum(k.duration for k in e.kernels)
    host = {s: sum(b - a for a, b in rs) for s, rs in ranges.items()}
    print("stages, device ms (host ms of the traced range): " + ", ".join(
        f"{s} {device[s] / 1e3:.3f} ({host[s] / 1e3:.2f})" for s in stages
    ) + f", other {device['other'] / 1e3:.3f}; sum {sum(device.values()) / 1e3:.3f} {tag}")


def check_detections(dets, B):
    import torch

    D = 100
    if tuple(dets.boxes.shape) != (B, D, 4) or tuple(dets.scores.shape) != (B, D):
        raise AssertionError(f"detections shape {tuple(dets.boxes.shape)}")
    for name, t in (("boxes", dets.boxes), ("scores", dets.scores)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite detection {name}")


# ---------------------------------------------------------------------------
# The label-verification path (DINO ViT + kNN vote)
# ---------------------------------------------------------------------------

ATTN_SHAPE = (64, 785, 6, 64)  # (B, N, H, d): 64 crops of 224 through ViT-S/8
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor cores: float32's tensor-core path
VIT_STAGES = ("patch_embed", "attention", "mlp")  # the profiler ranges in the ViT
MINI_SPLITS = (  # (dataset name, annotation file under the root; "" for the K-shot files)
    ("coco_trainval_all", "cocosplit/datasplit/trainvalno5k.json"),
    ("coco_trainval_all_2shot", ""),
)


def attention_bound(B, N, H, d, isz, ops_per_s):
    """Least time for the attention function: 4*B*H*N^2*d operations (QK^T
    and PV) at the dtype's dense tensor-core rate, against q, k, v read once
    and the output written once at the memory rate."""
    ops = 4 * B * H * N * N * d
    nbytes = 4 * B * N * H * d * isz
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), nbytes, ops


def peaked(qkv):
    """A peaked copy of qkv (B, N, 3, H, d) with N(0, 0.25) entries, numpy or
    torch: q and k scaled by 4, so at d = 64 and scale 1/8 the logits have a
    std of about 4, a row spans about 26 and its largest weight is about
    0.4; and the keys at N//2 + 3, N - 40 and N - 1 scaled by 2 more (logits
    of std about 8 there), so in about a sixth of the rows the running max
    jumps by tens late in the row and the online softmax's rescale
    exp(m_old - m_new) falls far below 1, as in trained attention. v is left
    as it is, so |out| stays under 2. (At N < 40 only the keys that exist.)"""
    N = qkv.shape[1]
    out = qkv * 1
    out[:, :, :2] *= 4
    out[:, sorted({j for j in (N // 2 + 3, N - 40, N - 1) if 0 <= j < N}), 1] *= 2
    return out


def attention_error(got, want, shape):
    """(max abs err, its share of the tolerance, text): float32 1e-5 max abs;
    bf16 2 bf16 ulps of the largest |out| of each (batch, head)."""
    import torch

    B, N, H, d = shape
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return float(err.max()), float(err.max()) / 1e-5, "tolerance 1e-5"
    mx = want.float().abs().view(B, N, H, d).amax(dim=(1, 3))
    ratio = float((err.view(B, N, H, d).amax(dim=(1, 3)) / bf16_ulp(mx)).max())
    return float(err.max()), ratio / 2, f"{ratio:.2f} bf16 ulps of the largest |out| of a (b, h); tolerance 2"


def attention_kernel_phase(tag):
    """The attention kernel and its plain version on the same seeded qkv at
    the main path's shape, float32 and bf16: error, card ms, the plain
    version's ms, the bound and scaled_dot_product_attention's ms on the same
    (B, H, N, d) tensors (a yardstick only; the port never calls it). The
    error is also held on a peaked qkv (``peaked``), whose logits span tens.
    Tolerances: float32 1e-5 max abs; bf16 2 bf16 ulps of the largest |out|
    of each (batch, head). Returns the float32 row (the CLI's dtype)."""
    import torch
    import torch.nn.functional as F

    from lvc_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    B, N, H, d = ATTN_SHAPE
    scale = d ** -0.5
    rows = {}
    for dtype, rate in ((torch.float32, TF32_OPS_PER_S), (torch.bfloat16, BF16_OPS_PER_S)):
        name = str(dtype).replace("torch.", "")
        g = torch.Generator(device="cuda").manual_seed(0)
        mild = (torch.randn(B, N, 3 * H * d, generator=g, device="cuda") * 0.5).view(B, N, 3, H, d)
        errs = {}
        for case, qkv in (("peaked", peaked(mild).to(dtype)), ("mild", mild.to(dtype))):
            got = flash_attention(qkv, scale)
            torch.cuda.synchronize()
            want = flash_attention_plain(qkv, scale)
            if tuple(got.shape) != (B, N, H * d) or not torch.isfinite(got).all():
                raise AssertionError(f"flash_attention_fwd {name} {case}: shape {tuple(got.shape)} or non-finite")
            errs[case] = attention_error(got, want, ATTN_SHAPE)
            if errs[case][1] > 1:
                raise AssertionError(f"flash_attention_fwd {name} {case}: max abs err {errs[case][0]} "
                                     f"({errs[case][2]})")
            if case == "peaked" and dtype == torch.float32:
                # both against float64 softmax attention: how much of their
                # difference is float32 rounding of logits that reach tens
                q, k, v = (t.transpose(1, 2).double() for t in qkv.unbind(2))
                exact = (torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1) @ v).transpose(1, 2)
                exact = exact.reshape(B, N, H * d)
                vs64 = [float((t.double() - exact).abs().max()) for t in (got, want)]
                del q, k, v, exact
            del got, want
        del mild
        max_abs_err, _, tol_text = errs["mild"]
        peak_text = f"peaked qkv max_abs_err {errs['peaked'][0]} ({errs['peaked'][2]})"
        if dtype == torch.float32:
            peak_text += f", against float64: kernel {vs64[0]:.3e}, plain {vs64[1]:.3e}"
        ms = cuda_ms(lambda: flash_attention(qkv, scale), 20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(qkv, scale), 3)
        wrapper_us, op_us = route_host_us(flash_attention, torch.ops.lvc_tpu_torch.flash_attention_fwd, qkv, scale)
        print(f"kernel flash_attention_fwd {name}: host us per call, wrapper {wrapper_us:.1f}, custom op "
              f"{op_us:.1f} {tag}")
        q, k, v = (t.transpose(1, 2).contiguous() for t in qkv.unbind(2))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
        bound_ms, bound_by, nbytes, ops = attention_bound(B, N, H, d, qkv.element_size(), rate)
        print(f"kernel flash_attention_fwd {name}: (B, N, H, d) {ATTN_SHAPE} max_abs_err {max_abs_err} "
              f"({tol_text}); {peak_text}; "
              f"ms {ms:.4f} plain_ms {plain_ms:.3f} sdpa_ms "
              f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}; {nbytes} bytes at 3.35 TB/s, {ops} "
              f"flops at {rate / 1e12:.0f} TFLOP/s) share of bound {bound_ms / ms:.3f}, kernel/sdpa "
              f"{ms / library_ms:.2f} {tag}")
        rows[name] = dict(
            name="flash_attention_fwd", route="cuda", source="lvc_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            replaces="lvc_tpu/modeling/backbone/vit.py:80", launches=0, max_abs_err=max_abs_err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            dtype=name, host_us=wrapper_us, op_host_us=op_us,
        )
        del qkv, q, k, v
    torch.cuda.empty_cache()
    bf16 = {key: rows["bfloat16"][key]
            for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms", "host_us", "op_host_us")}
    return dict(rows["float32"], bfloat16=bf16)


def clustered(seed, n_shot, n_query, classes, dim, device):
    """Seeded shot and query descriptors around class centres (float32)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 2
    s_cls = rng.randint(0, classes, n_shot)
    q_cls = rng.randint(0, classes, n_query)
    shots = centers[s_cls] + rng.randn(n_shot, dim)
    queries = centers[q_cls] + rng.randn(n_query, dim) * 1.5
    return tuple(torch.from_numpy(np.asarray(a, t)).to(device)
                 for a, t in ((shots, np.float32), (s_cls, np.int64), (queries, np.float32)))


def verify_reference_check(tag):
    """A narrow ViT at float32 (depth 2, dim 128, 2 heads, patch 16, 224
    crops: N = 197, not a multiple of any tile) on the card (kernel) and on
    the CPU (plain version) from the same weights: CLS descriptors within
    1e-5 of the largest |descriptor|. Then knn_vote on the card and on the
    CPU on seeded clustered descriptors: similarities within 1e-5, and equal
    top-k labels and modes where the k-th and (k+1)-th similarities are more
    than 1e-4 apart (all but near-ties, which are counted)."""
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.backbone.vit import VisionTransformer, random_init
    from lvc_tpu_torch.ops.attention import flash_attention
    from lvc_tpu_torch.ops.knn import knn_vote, similarity

    cpu = random_init(VisionTransformer(16, 128, 2, 2), seed=1).eval()
    gpu = VisionTransformer(16, 128, 2, 2).cuda().eval()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 224, 224, 3).astype(np.float32))
    before = flash_attention.launches
    with torch.no_grad():
        want = cpu(x)
        got = gpu(x.cuda()).cpu()
    launched = flash_attention.launches - before
    rel = float((got - want).abs().max() / want.abs().max())
    if launched != 2 or rel > 1e-5:
        raise AssertionError(f"narrow ViT card vs CPU: rel err {rel}, kernel launches {launched}")

    k = 10
    cs, cl, cq = clustered(3, 600, 2000, 12, 128, "cpu")
    sim_c = similarity(cs, cq)
    sim_g = similarity(cs.cuda(), cq.cuda()).cpu()
    sim_err = float((sim_c - sim_g).abs().max())
    top = sim_c.sort(dim=-1, descending=True).values
    clear = (top[:, k - 1] - top[:, k]) > 1e-4
    tk_c, mode_c = knn_vote(cs, cl, cq, k=k)
    tk_g, mode_g = knn_vote(cs.cuda(), cl.cuda(), cq.cuda(), k=k)
    tk_g, mode_g = tk_g.cpu(), mode_g.cpu()
    if sim_err > 1e-5 or not torch.equal(tk_c[clear], tk_g[clear]) or not torch.equal(mode_c[clear], mode_g[clear]):
        raise AssertionError(f"knn_vote card vs CPU: sim err {sim_err}, labels or modes differ")
    print(f"verify reference: narrow ViT (patch 16, dim 128, depth 2, N=197) card vs CPU at float32 "
          f"rel err {rel:.2e} (tol 1e-5), {launched} kernel launches; knn_vote S=600 Q=2000 D=128 k={k}: "
          f"sim err {sim_err:.2e} (tol 1e-5), top-k labels and modes equal on {int(clear.sum())} queries "
          f"({int((~clear).sum())} near-ties skipped; modes equal on all: {torch.equal(mode_c, mode_g)}) {tag}")


def verify_main_path(tag, kernels):
    """DINO ViT-S/8 at full width, seeded random weights, B=64 uint8 crops of
    224 through DescriptorExtractor.embed_crops, float32 (the CLI's dtype)
    and bf16: 1 warm-up and 5 timed calls each, with the kernel's count set to
    0 just before and read just after (12 launches per forward), one profiled
    call with the device time of the ViT's profiler ranges. Then knn_vote at
    a COCO size: S = 2,400 shots (30 x 80 classes), Q = 50,000 candidates,
    D = 384, k = 10, cosine."""
    import numpy as np
    import torch

    from lvc_tpu_torch.ops.attention import flash_attention
    from lvc_tpu_torch.ops.knn import knn_vote
    from lvc_tpu_torch.pipeline.verification import DescriptorExtractor, build_dino

    B, iters = 64, 5
    crops = (np.random.RandomState(0).rand(B, 224, 224, 3) * 255).astype(np.uint8)
    mean, std = [103.530, 116.280, 123.675], [57.375, 57.120, 58.395]
    desc = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        model = build_dino("dino_vits8", compute_dtype=dtype)
        ext = DescriptorExtractor(model, mean, std, batch=B)
        ext.embed_crops(crops)  # warm-up
        flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = ext.embed_crops(crops)  # returns numpy: synchronised
        ms = (time.perf_counter() - t0) * 1e3 / iters
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        if launches != 12 * iters:
            raise AssertionError(f"verify main path {name}: {launches} kernel launches, want {12 * iters}")
        if out.shape != (B, 384) or not np.isfinite(out).all():
            raise AssertionError(f"verify main path {name}: descriptors {out.shape} or non-finite")
        if dtype == torch.float32:
            kernels["flash_attention_fwd"]["launches"] = launches
        desc[name] = out
        print(f"verify main path DINO ViT-S/8 224 {name} B={B}: {ms:.2f} ms/batch {B * 1e3 / ms:.1f} crops/s, "
              f"launches {launches} ({iters} forwards), peak memory {peak / 2 ** 30:.2f} GiB {tag}")
        profile_call(lambda: ext.embed_crops(crops), ms, f"{name} forward", tag, VIT_STAGES)
        del model, ext
        torch.cuda.empty_cache()
    # the host's share of embed_crops: its float32 normalisation in numpy
    mean32, std32 = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    t0 = time.perf_counter()
    for _ in range(3):
        (crops.astype(np.float32) - mean32) / std32
    norm_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"verify main path: host normalisation of {B} crops in numpy {norm_ms:.2f} ms (host clock) {tag}")
    a, b = desc["float32"], desc["bfloat16"]
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    print(f"verify main path: bf16 vs float32 descriptor cosine min {cos.min():.6f} mean {cos.mean():.6f} {tag}")

    shots, classes, queries = clustered(4, 2400, 50000, 80, 384, "cuda")
    topk, mode = knn_vote(shots, classes, queries, k=10)
    torch.cuda.synchronize()
    if tuple(topk.shape) != (50000, 10) or int(mode.min()) < 0 or int(mode.max()) >= 80:
        raise AssertionError(f"knn_vote: top-k {tuple(topk.shape)}, modes in [{int(mode.min())}, {int(mode.max())}]")
    knn_ms = cuda_ms(lambda: knn_vote(shots, classes, queries, k=10), 10)
    print(f"knn_vote S=2400 Q=50000 D=384 k=10 cosine: {knn_ms:.3f} ms ({50000 / knn_ms * 1e3:.0f} queries/s) {tag}")


def cli_phase(tag):
    """The port's verification CLI on the card, on a seeded mini COCO tree
    (DINO ViT-S/16 with seeded random weights, k=3): the output JSON must
    exist, and the kernel must have been launched."""
    import json
    import os
    import tempfile

    from lvc_tpu_torch.data import builtin  # noqa: F401
    from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata
    from lvc_tpu_torch.data.catalog import DatasetCatalog
    from lvc_tpu_torch.data.meta_coco import register_meta_coco
    from lvc_tpu_torch.engine.defaults import default_argument_parser
    from lvc_tpu_torch.ops.attention import flash_attention
    from lvc_tpu_torch.tools import run_nearest_neighbours

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        candidates = write_mini_coco(root, seed=0)
        os.environ["DETECTRON2_DATASETS"] = root
        os.environ.pop("DINO_WEIGHTS", None)
        register_mini_coco(root, DatasetCatalog, register_meta_coco, _get_builtin_metadata("coco_fewshot"))
        before = flash_attention.launches
        t0 = time.perf_counter()
        run_nearest_neighbours.main(default_argument_parser().parse_args(
            cli_args(root, candidates, os.path.join(tmp, "out"))))
        secs = time.perf_counter() - t0
        out = candidates.replace(".json", "_dino_vits16_03_cosine.json")
        with open(out) as f:
            kept = json.load(f)["annotations"]
        with open(candidates) as f:
            n = len(json.load(f)["annotations"])
    launched = flash_attention.launches - before
    if launched < 12:
        raise AssertionError(f"the CLI launched the attention kernel {launched} times")
    print(f"cli: run_nearest_neighbours on the mini COCO tree (6 images, {n} candidates), DINO ViT-S/16 "
          f"random weights: kept {len(kept)} of {n}, {launched} kernel launches, {secs:.2f} s {tag}")


def write_mini_coco(root: str, seed: int = 0) -> str:
    """A seeded mini COCO tree in the layout the COCO registration reads:
    six PNG images under ``coco/trainval2014``, their instances
    (``cocosplit/datasplit/trainvalno5k.json``), 2-shot files for all 80
    classes (``cocosplit/full_box_2shot_<class>_trainval.json``; person and
    dog have 3 candidates each, so the 2-shot subsample draws) and
    ``candidates.json``, detector candidates on the other images with ids and
    scores, one of them on a truck (a seen class). Returns the candidates'
    path."""
    import json
    import os

    import numpy as np
    from PIL import Image

    from lvc_tpu_torch.data.builtin_meta import COCO_CATEGORIES

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "coco", "trainval2014")
    split_dir = os.path.join(root, "cocosplit", "datasplit")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(split_dir, exist_ok=True)
    H, W = 160, 200
    images = []
    for i in range(1, 7):
        low = rng.randint(0, 256, (H // 8, W // 8, 3)).astype(np.uint8)
        img = np.kron(low, np.ones((8, 8, 1), np.uint8))
        Image.fromarray(img).save(os.path.join(img_dir, f"img_{i}.png"))
        images.append({"id": i, "file_name": f"img_{i}.png", "height": H, "width": W})

    def box():
        w, h = rng.randint(24, 90, 2)
        x, y = rng.randint(0, W - w), rng.randint(0, H - h)
        return [float(x), float(y), float(w), float(h)]

    PERSON, DOG, TRUCK = 1, 18, 8
    gt = []
    for img in images:
        for cat in (PERSON, DOG, TRUCK):
            gt.append({"id": len(gt) + 1, "image_id": img["id"], "category_id": cat, "bbox": box(),
                       "iscrowd": 0})
    for a in gt:
        a["area"] = a["bbox"][2] * a["bbox"][3]
    cats = [{"id": c["id"], "name": c["name"]} for c in COCO_CATEGORIES]

    def dump(path, imgs, anns):
        with open(path, "w") as f:
            json.dump({"images": imgs, "annotations": anns, "categories": cats}, f)

    dump(os.path.join(split_dir, "trainvalno5k.json"), images, gt)
    shot_imgs = {PERSON: (1, 2, 3), DOG: (1, 2, 4)}
    for c in COCO_CATEGORIES:
        ids = shot_imgs.get(c["id"], ())
        anns = [a for a in gt if a["category_id"] == c["id"] and a["image_id"] in ids]
        dump(os.path.join(root, "cocosplit", f"full_box_2shot_{c['name']}_trainval.json"),
             [im for im in images if im["id"] in ids], anns)
    cands = []
    for img in images[3:]:
        for k in range(4):
            cands.append({"id": 1000 + len(cands), "image_id": img["id"], "category_id": (PERSON, DOG)[k % 2],
                          "bbox": box(), "score": float(rng.uniform(0.3, 1.0)), "iscrowd": 0})
        truck = next(a for a in gt if a["image_id"] == img["id"] and a["category_id"] == TRUCK)
        cands.append({"id": 1000 + len(cands), "image_id": img["id"], "category_id": PERSON,
                      "bbox": list(truck["bbox"]), "score": 0.9, "iscrowd": 0})
    for a in cands:
        a["area"] = a["bbox"][2] * a["bbox"][3]
    path = os.path.join(root, "candidates.json")
    dump(path, images[3:], cands)
    return path


COCO_TREE_SPLITS = (  # (dataset name, image directory, annotation file) under the root
    ("coco_trainval_base", "coco/trainval2014", "cocosplit/datasplit/trainvalno5k.json"),
    ("coco_trainval_all", "coco/trainval2014", "cocosplit/datasplit/trainvalno5k.json"),
    ("coco_test_base", "coco/val2014", "cocosplit/datasplit/5k.json"),
    ("coco_test_all", "coco/val2014", "cocosplit/datasplit/5k.json"),
)


def write_coco_tree(root: str, n_train: int, n_test: int, sizes=((480, 640), (640, 480)),
                    seed: int = 0, max_boxes: int = 8, crowd: float = 0.0, category_ids=None) -> None:
    """A seeded COCO tree in the layout the registrations read: JPEG images
    under ``coco/trainval2014`` and ``coco/val2014`` (their (h, w) cycling
    through ``sizes``), with ``cocosplit/datasplit/{trainvalno5k,5k}.json``.
    Each image has 1 to ``max_boxes`` boxes over ``category_ids`` (default:
    the 60 base classes), each drawn as a filled rectangle of a colour its
    class picks on blocky noise; a box is a crowd box with probability
    ``crowd``."""
    import json
    import os

    import numpy as np
    from PIL import Image

    from lvc_tpu_torch.data.builtin_meta import COCO_CATEGORIES, COCO_NOVEL_IDS

    rng = np.random.RandomState(seed)
    if category_ids is None:
        category_ids = [c["id"] for c in COCO_CATEGORIES if c["id"] not in COCO_NOVEL_IDS]
    cats = [{"id": c["id"], "name": c["name"]} for c in COCO_CATEGORIES]
    split_dir = os.path.join(root, "cocosplit", "datasplit")
    os.makedirs(split_dir, exist_ok=True)
    for img_sub, ann_file, n, first_id in (("coco/trainval2014", "trainvalno5k.json", n_train, 1),
                                           ("coco/val2014", "5k.json", n_test, 100001)):
        img_dir = os.path.join(root, img_sub)
        os.makedirs(img_dir, exist_ok=True)
        images, anns = [], []
        for i in range(n):
            H, W = sizes[i % len(sizes)]
            low = rng.randint(0, 200, (H // 16 + 1, W // 16 + 1, 3)).astype(np.uint8)
            img = np.kron(low, np.ones((16, 16, 1), np.uint8))[:H, :W].copy()
            img_id = first_id + i
            for _ in range(rng.randint(1, max_boxes + 1)):
                w, h = rng.randint(W // 16, W // 2), rng.randint(H // 16, H // 2)
                x, y = rng.randint(0, W - w), rng.randint(0, H - h)
                cat = int(category_ids[rng.randint(len(category_ids))])
                img[y:y + h, x:x + w] = ((cat * 37) % 256, (cat * 91) % 256, (cat * 151) % 256)
                anns.append({"id": len(anns) + 1 + 10 * first_id, "image_id": img_id, "category_id": cat,
                             "bbox": [float(x), float(y), float(w), float(h)], "area": float(w * h),
                             "iscrowd": int(rng.rand() < crowd)})
            name = f"img_{img_id:06d}.jpg"
            Image.fromarray(img).save(os.path.join(img_dir, name), quality=90)
            images.append({"id": img_id, "file_name": name, "height": H, "width": W})
        with open(os.path.join(split_dir, ann_file), "w") as f:
            json.dump({"images": images, "annotations": anns, "categories": cats}, f)


def register_coco_tree(root: str, catalog, register_meta_coco, metadata) -> None:
    """(Re)register the splits of ``COCO_TREE_SPLITS`` on the tree at
    ``root``, as ``register_all_coco(root)`` registers them."""
    import os

    for name, img_dir, annofile in COCO_TREE_SPLITS:
        if name in catalog:
            catalog.remove(name)
        register_meta_coco(name, metadata, os.path.join(root, img_dir), os.path.join(root, annofile))


def register_mini_coco(root: str, catalog, register_meta_coco, metadata) -> None:
    """(Re)register the splits of ``MINI_SPLITS`` on the mini tree at
    ``root``, as ``register_all_coco(root)`` registers them."""
    import os

    for name, annofile in MINI_SPLITS:
        if name in catalog:
            catalog.remove(name)
        register_meta_coco(name, metadata, os.path.join(root, "coco", "trainval2014"),
                           os.path.join(root, annofile))


VOC_SIZES = ((375, 500), (500, 375))  # VOC's (h, w)


def voc_xml(path: str, h: int, w: int, objects) -> None:
    """One VOC annotation file: ``objects`` are (class name, x0, y0, x1, y1,
    difficult) in 0-indexed pixels, written as VOC's 1-indexed corners."""
    import os

    lines = ["<annotation>", f"  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>"]
    for name, x0, y0, x1, y1, difficult in objects:
        lines.append(f"  <object><name>{name}</name><pose>Unspecified</pose><truncated>0</truncated>"
                     f"<difficult>{int(difficult)}</difficult><bndbox><xmin>{int(x0) + 1}</xmin>"
                     f"<ymin>{int(y0) + 1}</ymin><xmax>{int(x1)}</xmax><ymax>{int(y1)}</ymax></bndbox></object>")
    lines.append("</annotation>")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_voc_tree(root: str, n_trainval: int, n_test: int, n_2012: int, sizes=VOC_SIZES, seed: int = 0,
                   max_boxes: int = 4, difficult: float = 0.2, shot_seeds=()) -> None:
    """A seeded PASCAL VOC tree in the layout the VOC registration reads
    (``root`` is the ``datasets`` directory): ``VOC2007`` with ``trainval``
    and ``test`` ids (``000001``...), ``VOC2012`` with ``trainval`` ids that
    hold an underscore (``2008_000001``...), JPEGs whose (h, w) cycle through
    ``sizes``, and ``Annotations/*.xml`` with 1 to ``max_boxes`` objects, each
    ``<difficult>1</difficult>`` with probability ``difficult`` and drawn as
    a filled rectangle of its class's colour on blocky noise; the first
    object of the i-th trainval image is of the i-th class (mod 20), so
    every class has images. ``vocsplit/box_1shot_<cls>_train.txt`` lists
    the first two trainval images holding ``cls`` (a class with two records
    or more is subsampled to its one shot), and ``vocsplit/seed<k>/`` the
    next two, for each k of ``shot_seeds``."""
    import os

    import numpy as np
    from PIL import Image

    from lvc_tpu_torch.data.builtin_meta import PASCAL_VOC_ALL_CATEGORIES

    classes = sorted(PASCAL_VOC_ALL_CATEGORIES[1])
    rng = np.random.RandomState(seed)
    holders = {c: [] for c in classes}  # trainval ids holding each class, in writing order
    splits = (("VOC2007", "trainval", [f"{i:06d}" for i in range(1, n_trainval + 1)]),
              ("VOC2007", "test", [f"{i:06d}" for i in range(n_trainval + 1, n_trainval + n_test + 1)]),
              ("VOC2012", "trainval", [f"2008_{i:06d}" for i in range(1, n_2012 + 1)]))
    k = 0
    for year_dir, split, ids in splits:
        base = os.path.join(root, year_dir)
        os.makedirs(os.path.join(base, "JPEGImages"), exist_ok=True)
        os.makedirs(os.path.join(base, "ImageSets", "Main"), exist_ok=True)
        for fid in ids:
            H, W = sizes[k % len(sizes)]
            low = rng.randint(0, 200, (H // 16 + 1, W // 16 + 1, 3)).astype(np.uint8)
            img = np.kron(low, np.ones((16, 16, 1), np.uint8))[:H, :W].copy()
            objects = []
            for j in range(rng.randint(1, max_boxes + 1)):
                w, h = rng.randint(W // 10, W // 2), rng.randint(H // 10, H // 2)
                x, y = rng.randint(0, W - w), rng.randint(0, H - h)
                c = k % 20 if j == 0 and split == "trainval" else rng.randint(20)
                img[y:y + h, x:x + w] = ((c * 37) % 256, (c * 91) % 256, (c * 151) % 256)
                objects.append((classes[c], x, y, x + w, y + h, rng.rand() < difficult))
                if split == "trainval" and fid not in holders[classes[c]]:
                    holders[classes[c]].append(fid)
            Image.fromarray(img).save(os.path.join(base, "JPEGImages", fid + ".jpg"), quality=90)
            voc_xml(os.path.join(base, "Annotations", fid + ".xml"), H, W, objects)
            k += 1
        with open(os.path.join(base, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    for j, sub in enumerate([""] + [f"seed{s}" for s in shot_seeds]):
        d = os.path.join(root, "vocsplit", sub)
        os.makedirs(d, exist_ok=True)
        for c in classes:
            picks = holders[c][2 * j:2 * j + 2] or holders[c][:1]
            with open(os.path.join(d, f"box_1shot_{c}_train.txt"), "w") as f:
                f.write("\n".join(f"datasets/VOC{'2012' if '_' in p else '2007'}/JPEGImages/{p}.jpg"
                                  for p in picks) + "\n")


def cli_args(root: str, candidates: str, out_dir: str):
    """The verification CLI's arguments on the mini tree: ViT-S/16, k=3,
    cosine, seed 0 (the K-shot subsample draws from numpy's seeded state)."""
    return [
        "--eval-only",
        "QUERY_EXPAND.NN_MODEL", "dino_vits16",
        "QUERY_EXPAND.KNN", "3",
        "QUERY_EXPAND.COSINE_SIM", "True",
        "QUERY_EXPAND.NN_DSET", "('coco_trainval_all_2shot',)",
        "DATASETS.DT_PATH", f"('{candidates}',)",
        "DATASETS.TRAIN", "('coco_trainval_all',)",
        "SEED", "0",
        "OUTPUT_DIR", out_dir,
    ]


# ---------------------------------------------------------------------------
# The opt-in fused residual GEMM (LVC_TPU_FUSED_RESIDUAL=1)
# ---------------------------------------------------------------------------

# (name, B, H, W, K, N, ReLU, calls per R-101-FPN forward): the fused calls of
# the serving path at 8x832x1344 (every bottleneck conv3 and the FPN laterals
# of the sum top-down path); R-50 has 6 res4 blocks, not 23
FUSED_SHAPES = (
    ("res2 conv3", 8, 208, 336, 64, 256, True, 3),
    ("res3 conv3", 8, 104, 168, 128, 512, True, 4),
    ("res4 conv3", 8, 52, 84, 256, 1024, True, 23),
    ("res5 conv3", 8, 26, 42, 512, 2048, True, 3),
    ("lateral p4", 8, 52, 84, 1024, 256, False, 1),
    ("lateral p3", 8, 104, 168, 512, 256, False, 1),
    ("lateral p2", 8, 208, 336, 256, 256, False, 1),
)
FUSED_SOURCE = "lvc_tpu_torch/ops/csrc/fused_matmul.cu"
FUSED_REPLACES = "lvc_tpu/ops/fused_matmul.py:76"


def fused_calls(model):
    """(per forward, recomputed per train step): the Conv2d calls the fused
    gate takes in ``model``'s backbone, one per bottleneck conv3 and one per
    FPN lateral that has a level above it (fuse_type sum); and, under REMAT
    in training, the conv3 of every block that the backward recomputes, which
    is every block with a trainable parameter (the frozen stages take no
    gradient; FREEZE_AT 2 freezes the stem and res2)."""
    fpn = model.backbone
    blocks = [b for name in fpn.bottom_up.stage_names for b in getattr(fpn.bottom_up, name)]
    forward = len(blocks) + (len(fpn.in_features) - 1 if fpn.fuse_type == "sum" else 0)
    recomputed = sum(any(p.requires_grad for p in b.parameters()) for b in blocks) if fpn.bottom_up.remat else 0
    return forward, recomputed


def fused_error(got, want, x2d, w_kn, scale, shift, res2d):
    """Per element, the kernel against its plain version: 1 bf16 ulp of the
    plain result plus 1e-5 * S, S = |x| @ |w| * |scale| + |shift| + |res|
    (the float32 summation orders differ; where the sum cancels towards 0
    the difference is many of the small result's own ulps). Returns (ok, max
    abs err, elements at 1 ulp, elements over 1 ulp alone, max err / S of
    those)."""
    import torch

    g, w = got.float(), want.float()
    S = (x2d.float().abs() @ w_kn.float().abs()) * scale.abs() + shift.abs() + res2d.float().abs()
    err = (g - w).abs()
    ulp = bf16_ulp(w)
    ok = bool((err <= ulp + 1e-5 * S).all())
    over = err > ulp
    n_over = int(over.sum())
    ratio = float((err[over] / S[over]).max()) if n_over else 0.0
    del S
    return ok, float(err.max()), int(((err > 0) & ~over).sum()), n_over, ratio


def fused_bound(M, K, N):
    """Least time for one call: x, w, residual read once and out written once
    (bf16) over the memory rate, against 2*M*K*N operations at the dense bf16
    tensor-core rate."""
    nbytes = 2 * (M * K + K * N + 2 * M * N)
    ops = 2 * M * K * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def fused_kernel_phase(tag):
    """The fused GEMM kernel and its plain version on seeded bf16 inputs at
    each shape of FUSED_SHAPES (folded-BN-like scale in [0.5, 1.5], shift
    N(0, 1)), ReLU on and off, and a ragged M of 1,000 rows: error
    (``fused_error``), card ms, plain ms and the bound; beside them, as
    information only, the unfused tail of today's Conv2d on the same tensors
    (cuDNN 1x1 conv, FrozenBN, residual add, ReLU; or conv with bias and the
    add) and torch.matmul's bare product. No one PyTorch call computes the
    GEMM with this epilogue, so there is no library time. Returns the
    kernel's row, its times summed over the 36 calls of one R-101-FPN
    forward."""
    import torch
    import torch.nn.functional as F

    from lvc_tpu_torch.modeling.layers import Conv2d, fused_residual
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual as kernel
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual_plain as plain

    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, unfused_ms=0.0, matmul_ms=0.0)
    max_err, shapes, host, op_host = 0.0, [], [], []
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, B, H, W, K, N, relu, calls in FUSED_SHAPES:
        x = torch.randn(B, H, W, K, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(N, K, generator=g, device="cuda") * K ** -0.5).to(torch.bfloat16)
        scale = torch.rand(N, generator=g, device="cuda") + 0.5
        shift = torch.randn(N, generator=g, device="cuda")
        res = torch.randn(B, H, W, N, generator=g, device="cuda").to(torch.bfloat16)
        M = B * H * W
        x2d, res2d, w_kn = x.view(M, K), res.view(M, N), w.t()
        cases = [(M, relu), (M, not relu)] + ([(1000, relu)] if name == "res2 conv3" else [])
        for rows, r in cases:
            args = (x2d[:rows], w_kn, scale, shift, res2d[:rows])
            got = kernel(*args, relu=r)
            torch.cuda.synchronize()
            want = plain(*args, relu=r)
            if tuple(got.shape) != (rows, N) or got.dtype != torch.bfloat16 or not torch.isfinite(got).all():
                raise AssertionError(f"matmul_affine_residual {name}: shape, dtype or non-finite")
            ok, err, at_ulp, over, ratio = fused_error(got, want, *args)
            if not ok:
                raise AssertionError(f"matmul_affine_residual {name} M={rows} relu={r}: max abs err {err}, "
                                     f"over 1 bf16 ulp + 1e-5 * S")
            max_err = max(max_err, err)
            print(f"kernel matmul_affine_residual {name} (M, K, N) ({rows}, {K}, {N}) relu {r}: max_abs_err "
                  f"{err} ({at_ulp} elements at 1 bf16 ulp, {over} over it alone, max err/S {ratio:.2e}; "
                  f"tolerance 1 ulp + 1e-5 * S) {tag}")
            del got, want
        ms = cuda_ms(lambda: kernel(x2d, w_kn, scale, shift, res2d, relu=relu), 20)
        wrapper_us, op_us = route_host_us(kernel, torch.ops.lvc_tpu_torch.matmul_affine_residual,
                                          x2d, w_kn, scale, shift, res2d, relu)
        plain_ms = cuda_ms(lambda: plain(x2d, w_kn, scale, shift, res2d, relu=relu), 3)
        matmul_ms = cuda_ms(lambda: torch.matmul(x2d, w_kn), 20)
        conv = (Conv2d(K, N, kernel_size=1, bias=False, norm="FrozenBN", activation=F.relu) if relu
                else Conv2d(K, N, kernel_size=1, bias=True)).cuda().to(memory_format=torch.channels_last)
        with torch.no_grad():
            conv.weight.copy_(w.float().view(N, K, 1, 1))
            if relu:
                conv.norm.weight.copy_(scale)
                conv.norm.bias.copy_(shift)
            else:
                conv.bias.copy_(shift)
        x_nchw, res_nchw = x.permute(0, 3, 1, 2), res.permute(0, 3, 1, 2)
        with fused_residual(False), torch.no_grad():
            unfused_ms = cuda_ms(lambda: conv(x_nchw, residual=res_nchw), 20)
        bound_ms, bound_by, nbytes, ops = fused_bound(M, K, N)
        print(f"kernel matmul_affine_residual {name} (M, K, N) ({M}, {K}, {N}) x{calls} per R-101 forward: "
              f"ms {ms:.4f} plain_ms {plain_ms:.3f} bound_ms {bound_ms:.4f} ({bound_by}; {nbytes} bytes, "
              f"{ops} flops) share of bound {bound_ms / ms:.3f}; unfused Conv2d tail ms {unfused_ms:.4f}, "
              f"torch.matmul product alone ms {matmul_ms:.4f}; host us per call, wrapper {wrapper_us:.1f}, custom op "
              f"{op_us:.1f} {tag}")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                       ("unfused_ms", unfused_ms), ("matmul_ms", matmul_ms)):
            total[key] += calls * v
        host.append(wrapper_us)
        op_host.append(op_us)
        shapes.append(dict(shape=[M, K, N], calls=calls, ms=ms, bound_ms=bound_ms, plain_ms=plain_ms,
                           unfused_ms=unfused_ms, host_us=wrapper_us, op_host_us=op_us))
        del x, w, res, x2d, res2d, w_kn, conv, x_nchw, res_nchw
        torch.cuda.empty_cache()
    host_mean, op_host_mean = sum(host) / len(host), sum(op_host) / len(op_host)
    print(f"kernel matmul_affine_residual, the 36 calls of one R-101-FPN forward: ms {total['ms']:.4f} "
          f"bound_ms {total['bound_ms']:.4f} share of bound "
          f"{total['bound_ms'] / total['ms']:.3f} plain_ms {total['plain_ms']:.3f} unfused Conv2d tails ms "
          f"{total['unfused_ms']:.4f} torch.matmul products ms {total['matmul_ms']:.4f}; host us per call, "
          f"wrapper {host_mean:.1f}, custom op {op_host_mean:.1f} (means of the seven shapes) {tag}")
    return dict(
        name="matmul_affine_residual", route="cuda", source=FUSED_SOURCE, replaces=FUSED_REPLACES,
        launches=0, max_abs_err=max_err, ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"], bound_by="bytes", library_ms=None,
        host_us=host_mean, op_host_us=op_host_mean,
        work="the 36 calls of one R-101-FPN forward at 8x832x1344 (times summed)",
        shapes=shapes,
    )


def fused_reference_check(tag):
    """A narrow R-50-FPN in bf16 with the fused path on, on the card (kernel)
    and on the CPU (plain version), from the same weights: FPN outputs within
    2e-2 of each level's max |p| (bf16 convolutions of cuDNN and of the CPU
    round differently through 16 blocks), the kernel launched once per fused
    call (19); proposals as sets, since bf16 near-ties reorder the top-k: the
    same number valid, and in each image at least 85% of the card's valid
    proposals with a CPU proposal at IoU >= 0.9 (95-96% between the fused
    and unfused bf16 forms on the CPU)."""
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.layers import fused_residual
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual
    from lvc_tpu_torch.structures.boxes import pairwise_iou

    rng = np.random.RandomState(3)
    batch = {
        "image": (rng.rand(2, 128, 192, 3) * 255).astype(np.float32),
        "image_size": np.array([[128, 192], [112, 160]], np.int32),
    }
    cfg = narrow_cfg("pallas_fast")
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
    cpu = build_model(cfg, device="cpu")
    calibrated_init(cpu, seed=0)
    gpu = build_model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    with fused_residual(True):
        want = cpu.backbone_features(batch)
        before = matmul_affine_residual.launches
        got = gpu.backbone_features(batch)
        torch.cuda.synchronize()
        launched = matmul_affine_residual.launches - before
        c_props, _, c_valid = cpu.proposals(batch)
        g_props, _, g_valid = (t.cpu() for t in gpu.proposals(batch))
    expected = fused_calls(gpu)[0]
    if launched != expected:
        raise AssertionError(f"fused reference: {launched} kernel launches, want {expected}")
    rels = {k: float((got[k].cpu().float() - v.float()).abs().max() / v.float().abs().max()) for k, v in want.items()}
    if max(rels.values()) > 2e-2:
        raise AssertionError(f"fused reference: FPN outputs card vs CPU {rels}")
    matched = []
    for i in range(2):
        best = pairwise_iou(g_props[i][g_valid[i]], c_props[i][c_valid[i]]).max(1).values
        matched.append(float((best >= 0.9).float().mean()))
    if int(c_valid.sum()) != int(g_valid.sum()) or min(matched) < 0.85:
        raise AssertionError(f"fused reference: proposals valid {int(g_valid.sum())} vs {int(c_valid.sum())}, "
                             f"share matched at IoU 0.9 {matched}")
    print(f"fused reference: narrow R-50-FPN bf16 card vs CPU, FPN max err / max |p| "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(rels.items()))
          + f" (tol 2e-2), {launched} kernel launches (want {expected}); {int(g_valid.sum())} proposals valid "
          f"on both, share with a CPU proposal at IoU >= 0.9: {matched} (tol 0.85) {tag}")


def fused_main_path(tag, kernels, unfused_ms):
    """R-101-FPN serving as in main_path, fused and unfused on the same model
    in turns (unfused, fused, fused, unfused; 3 timed forwards each after one
    warm-up of each form), so both see the same host and card: every kernel
    count set to 0 just before the first fused turn and read just after (36
    fused launches per forward); ms/batch of both forms beside the unfused
    main path's of this run; one profiled fused forward; then the
    check_fused_serving comparison at B=8."""
    import torch

    from lvc_tpu_torch.modeling.layers import fused_residual
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual
    from lvc_tpu_torch.tools import check_fused_serving
    from lvc_tpu_torch.utils.init import damped_init

    wrappers = {"roi_align_band": ra.roi_align_band, "roi_align_paired": ra.roi_align_paired,
                "matmul_affine_residual": matmul_affine_residual}
    model = damped_init(build_model(serving_cfg("pallas_fast")), seed=0)
    per_forward = fused_calls(model)[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, W = 8, 832, 1344
    batch = {
        "image": torch.rand(B, H, W, 3, generator=g, device="cuda") * 255,
        "image_size": torch.tensor([[H, W]] * B, dtype=torch.int32, device="cuda"),
    }
    iters = 3

    def turn(fused):
        with fused_residual(fused):
            t0 = time.perf_counter()
            for _ in range(iters):
                dets = model(batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / iters, dets

    for fused in (False, True):  # warm-up
        with fused_residual(fused):
            model(batch)
    torch.cuda.synchronize()
    u1, _ = turn(False)
    for w in wrappers.values():
        w.launches = 0
    f1, dets = turn(True)
    counts = {k: w.launches for k, w in wrappers.items()}
    if counts["matmul_affine_residual"] != per_forward * iters or counts["roi_align_band"] < iters:
        raise AssertionError(f"fused main path: launches {counts}, want {per_forward} fused per forward")
    kernels["matmul_affine_residual"]["launches"] = counts["matmul_affine_residual"]
    check_detections(dets, B)
    f2, _ = turn(True)
    u2, _ = turn(False)
    ms, u_ms = (f1 + f2) / 2, (u1 + u2) / 2
    print(f"fused main path R-101-FPN 832x1344 bf16 pallas_fast B={B} LVC_TPU_FUSED_RESIDUAL=1, in turns "
          f"unfused/fused/fused/unfused: {u1:.2f}, {f1:.2f}, {f2:.2f}, {u2:.2f} ms/batch; fused {ms:.2f} ms/batch "
          f"{B * 1e3 / ms:.2f} img/s, unfused {u_ms:.2f} ms/batch {B * 1e3 / u_ms:.2f} img/s, speedup "
          f"{u_ms / ms:.3f}x (unfused main path earlier in this run: {unfused_ms:.2f} ms/batch); launches "
          f"{counts} ({per_forward} fused per forward) {tag}")
    with fused_residual(True):
        profile_call(lambda: model(batch), ms, "fused forward", tag)
    del model
    torch.cuda.empty_cache()
    print(f"check_fused_serving --batch {B} --iters 3: {tag}")
    res = check_fused_serving.compare(batch=B, height=H, width=W, iters=3)
    if res["valid_fused"] != res["valid_unfused"]:
        raise AssertionError(f"check_fused_serving: valid counts differ {res}")
    torch.cuda.empty_cache()


def fused_train_path(tag, kernels, unfused):
    """The R-50-FPN AMP train step as in train_main_path, fused and unfused on
    the same model in turns (unfused, fused, fused, unfused; 5 timed steps
    each after one warm-up step of each form): every kernel count set to 0
    just before the first fused turn and read just after, the fused launches
    per step derived from the model (``fused_calls``: 19 forward + 13
    recomputed under REMAT), finite losses, ms/step and peak memory of both
    forms beside the unfused train path's of this run, one profiled fused
    step."""
    import torch

    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.layers import fused_residual
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer
    from lvc_tpu_torch.utils.init import damped_init

    wrappers = {"roi_align_paired": ra.roi_align_paired, "roi_align_paired_bwd": ra.roi_align_paired_bwd,
                "matmul_affine_residual": matmul_affine_residual}
    cfg = train_cfg()
    model = damped_init(build_model(cfg), seed=0).train()
    opt = build_optimizer(cfg, model)  # sets requires_grad by FREEZE_AT
    forward, recomputed = fused_calls(model)
    step = make_train_step(model, opt, build_lr_schedule(cfg, opt), mixed_precision=cfg.SOLVER.AMP.ENABLED)
    B, H, W = 8, 832, 1344
    batch = train_batch(B, H, W, cfg.PAD.MAX_GT_PER_IMAGE, seed=0, device="cuda",
                        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = 5

    def turn(fused):
        with fused_residual(fused):
            t0 = time.perf_counter()
            metrics = [step(batch, gen) for _ in range(steps)]
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / steps, metrics

    for fused in (False, True):  # warm-up
        with fused_residual(fused):
            step(batch, gen)
    torch.cuda.synchronize()
    u1, _ = turn(False)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    f1, metrics = turn(True)
    counts = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    want = (forward + recomputed) * steps
    if counts["matmul_affine_residual"] != want or min(counts.values()) < steps:
        raise AssertionError(f"fused train path: launches {counts}, want {forward} + {recomputed} fused per step")
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"fused train path: non-finite losses {losses}")
    kernels["matmul_affine_residual"]["train_launches"] = counts["matmul_affine_residual"]
    f2, _ = turn(True)
    torch.cuda.reset_peak_memory_stats()
    u2, _ = turn(False)
    u_peak = torch.cuda.max_memory_allocated()
    ms, u_ms = (f1 + f2) / 2, (u1 + u2) / 2
    print(f"fused train path R-50-FPN 832x1344 AMP bf16 pallas_train B={B} LVC_TPU_FUSED_RESIDUAL=1, in turns "
          f"unfused/fused/fused/unfused: {u1:.2f}, {f1:.2f}, {f2:.2f}, {u2:.2f} ms/step; fused {ms:.2f} ms/step "
          f"{B * 1e3 / ms:.2f} img/s, peak memory {peak / 2 ** 30:.2f} GiB; unfused {u_ms:.2f} ms/step, peak "
          f"{u_peak / 2 ** 30:.2f} GiB; speedup {u_ms / ms:.3f}x (unfused train path earlier in this run: "
          f"{unfused[0]:.2f} ms/step); launches {counts} ({forward} forward + {recomputed} recomputed under "
          f"REMAT per step) {tag}")
    for i, m in enumerate(losses):
        print(f"  step {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items())) + f" {tag}")
    with fused_residual(True):
        profile_call(lambda: step(batch, gen), ms, "fused train step", tag, TRAIN_STAGES)
    del model, opt
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The training CLI (twin of tools/train_net.py): loaders, DefaultTrainer,
# checkpoints, COCO evaluation
# ---------------------------------------------------------------------------

TRAIN_NET_YAML = "configs/COCO-detection/faster_rcnn_R_50_FPN_base.yaml"


def use_coco_tree(root: str) -> None:
    """Point ``DETECTRON2_DATASETS`` at a tree that ``write_coco_tree`` wrote
    and register its splits in the port's catalog."""
    import os

    from lvc_tpu_torch.data import builtin  # noqa: F401
    from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata
    from lvc_tpu_torch.data.catalog import DatasetCatalog
    from lvc_tpu_torch.data.meta_coco import register_meta_coco

    os.environ["DETECTRON2_DATASETS"] = root
    register_coco_tree(root, DatasetCatalog, register_meta_coco, _get_builtin_metadata("coco_fewshot"))


def trainer_reference_cfg(device: str, out_dir: str):
    """The narrow R-50-FPN of the training reference check (tests/
    test_torch_train.py's ``_narrow``: 64-wide res2 and FPN, exhaustive
    sampling, float32) with 60 base classes and POOLER_IMPL pallas_train (K2
    and K3 on the card, their plain versions on the CPU), trained 3
    iterations on 96x128 images at batch 2 with the gate's gradient clipping
    (norm 1.0: unclipped, the random head's first steps drive every class
    score below 1e-30), and evaluated with a score threshold of 0.001, so
    that its random detector emits rows."""
    cfg = narrow_cfg("pallas_train")
    cfg.MODEL.DEVICE = device
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 60
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192
    cfg.MODEL.RPN.POSITIVE_FRACTION = 0.999
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 128
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.999
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 300
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 200
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.001
    cfg.PAD.MAX_GT_PER_IMAGE = 8
    cfg.PAD.CANVAS_BUCKETS = [[128, 192]]
    cfg.INPUT.MIN_SIZE_TRAIN = (96,)
    cfg.INPUT.MAX_SIZE_TRAIN = 192
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE_TEST = 192
    cfg.DATASETS.TRAIN = ("coco_trainval_base",)
    cfg.DATASETS.TEST = ("coco_test_base",)
    cfg.DATALOADER.NUM_WORKERS = 1
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    cfg.SOLVER.MAX_ITER = 3
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.SEED = 3
    cfg.OUTPUT_DIR = out_dir
    return cfg


def result_rows(path: str):
    """An evaluator's COCO result rows in (image, category, score) order."""
    with open(path) as f:
        return sorted(json.load(f), key=lambda r: (r["image_id"], r["category_id"], -r["score"]))


def trainer_reference_check(tag):
    """``DefaultTrainer`` on the card and on the CPU from the same weights on
    one seeded mini COCO tree (6 train and 4 test images of 96x128, one
    loader worker, so both see the same batches): 3 iterations, then the
    final evaluation. Each iteration's losses (the storages' histories) and
    the ``metrics.json`` rows within rel 1e-4; the result rows matched
    in (image, category, score) order, boxes within 1e-2 px and scores within
    rel 1e-3; the AP dicts within 1e-2 (points of AP)."""
    import json
    import os
    import tempfile

    import torch

    from lvc_tpu_torch.engine.defaults import DefaultTrainer
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        write_coco_tree(root, 6, 4, sizes=((96, 128),), seed=1, max_boxes=5)
        use_coco_tree(root)
        ref = build_model(trainer_reference_cfg("cpu", ""), device="cpu")
        calibrated_init(ref, seed=0)
        with torch.no_grad():
            ref.roi_heads.box_predictor.cls_score.weight.mul_(5.0)  # scores spread over (0, 1)
        weights = ref.state_dict()

        class RefTrainer(DefaultTrainer):
            def _materialize(self, model, seed):
                model.load_state_dict(weights)

        runs = {}
        for device in ("cpu", "cuda"):
            before = ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches
            out = os.path.join(tmp, device)
            trainer = RefTrainer(trainer_reference_cfg(device, out))
            results = trainer.train()
            launched = (ra.roi_align_paired.launches - before[0], ra.roi_align_paired_bwd.launches - before[1])
            rows = result_rows(os.path.join(out, "inference", "coco_instances_test_results.json"))
            with open(os.path.join(out, "metrics.json")) as f:
                metrics = [json.loads(line) for line in f]
            losses = {k: h.values() for k, h in trainer.storage.histories().items() if k.startswith(("loss", "total"))}
            runs[device] = losses, metrics, rows, results, launched
    (c_loss, c_rows_m, c_rows, c_res, c_n), (g_loss, g_rows_m, g_rows, g_res, g_n) = runs["cpu"], runs["cuda"]
    if c_n != (0, 0) or g_n != (3 + 4, 3):
        raise AssertionError(f"K2/K3 launches: CPU run {c_n}, card run {g_n} (want 0/0 and 7/3)")
    loss_err = max(abs(g - c) / max(abs(c), 1e-30) for k in c_loss for g, c in zip(g_loss[k], c_loss[k]))
    if set(c_loss) != set(g_loss) or any(len(v) != 3 for v in c_loss.values()) or loss_err > 1e-4:
        raise AssertionError(f"trainer losses differ: cpu {c_loss} card {g_loss}")
    row_err = max(abs(g[k] - c[k]) / max(abs(c[k]), 1e-30) for c, g in zip(c_rows_m, g_rows_m)
                  for k in c if k.startswith(("loss", "total")))
    if [r["iteration"] for r in c_rows_m] != [r["iteration"] for r in g_rows_m] or not c_rows_m or row_err > 1e-4:
        raise AssertionError(f"metrics.json rows differ (max rel err {row_err})")
    if len(c_rows) != len(g_rows) or len(c_rows) < 100:
        raise AssertionError(f"result rows: {len(c_rows)} on the CPU, {len(g_rows)} on the card")
    box_err = score_err = 0.0
    for c, g in zip(c_rows, g_rows):
        if (c["image_id"], c["category_id"]) != (g["image_id"], g["category_id"]):
            raise AssertionError(f"result rows differ: {c} vs {g}")
        box_err = max(box_err, max(abs(a - b) for a, b in zip(c["bbox"], g["bbox"])))
        score_err = max(score_err, abs(c["score"] - g["score"]) / c["score"])
    ap_err = max(abs(c_res["bbox"][k] - g_res["bbox"][k]) for k in c_res["bbox"] if "-" not in k)
    if box_err > 1e-2 or score_err > 1e-3 or ap_err > 1e-2 or set(c_res["bbox"]) != set(g_res["bbox"]):
        raise AssertionError(f"evaluation differs: box {box_err} score {score_err} AP {ap_err}")
    print(f"trainer reference: DefaultTrainer card vs CPU at float32, 3 iterations, losses "
          f"{ {k: round(v[-1], 5) for k, v in c_loss.items()} } max rel err {loss_err:.2e} (tol 1e-4), "
          f"metrics.json rows {row_err:.2e}; eval {len(c_rows)} rows box err {box_err:.2e} px (tol 1e-2) "
          f"score rel err {score_err:.2e} (tol 1e-3), bAP {c_res['bbox']['bAP']:.4f} vs "
          f"{g_res['bbox']['bAP']:.4f} (max AP err {ap_err:.2e}, tol 1e-2); K2/K3 launches {g_n[0]}/{g_n[1]} {tag}")


TRAIN_NET_ITERS, TRAIN_NET_PERIOD, TRAIN_NET_RESUMED = 30, 15, 35
TF32_ITERS = 10  # each of the float32 runs with TF32 off and on
TRAIN_NET_TREE = (48, 16)  # train and test images


def run_cli(module, argv, trainer="Trainer"):
    """``module.main`` on ``argv`` in this process, every kernel count set to
    0 just before and read just after. Unless ``trainer`` is None,
    ``module.<trainer>`` is replaced for the call by a subclass that keeps,
    on the instance, each step's wall seconds and K2/K3 launches
    (``step_s``, ``step_launches``) and its last evaluation's wall seconds
    and K2/K3 launches (``test_s``, ``test_launches``). Returns (results,
    seconds, (K1, K2, K3) launches, the trainer or None)."""
    import torch

    from lvc_tpu_torch.engine.defaults import default_argument_parser
    from lvc_tpu_torch.ops import roi_align as ra

    k2, k3 = ra.roi_align_paired, ra.roi_align_paired_bwd  # the wrappers that count (PoolRecorder stands in)
    made = []
    saved = getattr(module, trainer) if trainer else None
    if trainer:
        class Capture(saved):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)
                self.step_s, self.step_launches = [], []
                self.test_s = self.test_launches = None

            def run_step(self):
                n = k2.launches, k3.launches
                t0 = time.perf_counter()
                super().run_step()
                self.step_s.append(time.perf_counter() - t0)
                self.step_launches.append((k2.launches - n[0], k3.launches - n[1]))

            @classmethod
            def test(cls, cfg, model):
                n = k2.launches, k3.launches
                t0 = time.perf_counter()
                res = super().test(cfg, model)
                torch.cuda.synchronize()
                made[-1].test_s = time.perf_counter() - t0
                made[-1].test_launches = k2.launches - n[0], k3.launches - n[1]
                return res

        setattr(module, trainer, Capture)
    ra.roi_align_band.launches = k2.launches = k3.launches = 0
    try:
        t0 = time.perf_counter()
        res = module.main(default_argument_parser().parse_args(argv))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        if trainer:
            setattr(module, trainer, saved)
    return res, secs, (ra.roi_align_band.launches, k2.launches, k3.launches), made[-1] if made else None


def train_net_report(what, trainer, secs, peak, ims, tag):
    """Prints a training run's line: ms/iter and img/s over the steps after
    the first 3 (the IterationTimer's warm-up; loader waits included), the
    ``time`` scalar's median, data_time, peak memory and K2/K3 per
    iteration. Returns the ms/iter."""
    import statistics

    steps = trainer.step_s[3:]
    hist = trainer.storage.histories()
    times, data = hist["time"].values(), hist["data_time"].values()
    ms = sum(steps) / len(steps) * 1e3
    print(f"{what}: {len(trainer.step_s)} iterations in {secs:.1f} s with its evaluation; the {len(steps)} after the "
          f"first 3 in {sum(steps):.3f} s, {ms:.2f} ms/iter, {ims * len(steps) / sum(steps):.2f} img/s end to end "
          f"(loader waits and stalls included); `time` scalar median {statistics.median(times) * 1e3:.2f} ms over "
          f"the last {len(times)}; data_time median {statistics.median(data) * 1e3:.2f} ms (max "
          f"{max(data) * 1e3:.2f}); peak memory {peak:.2f} GiB; K2/K3 per iteration "
          f"{sorted(set(trainer.step_launches))} {tag}")
    return ms


def train_net_path(tag, keep: str):
    """The training CLI's main path at full width: ``train_net.main`` in this
    process on faster_rcnn_R_50_FPN_base.yaml (R-50-FPN, 60 base classes,
    IMS_PER_BATCH 16, the 832x1344 canvas, POOLER_IMPL auto: K2 and K3 in
    training, K2 in evaluation) from a damped-init ``.pth``, with AMP,
    BASE_LR 1e-4, 30 iterations and a checkpoint every 15, on a seeded COCO
    tree of 48 train and 16 test JPEGs of 480x640 and 640x480 with 1-8 boxes
    each; the score threshold is 0.001, so that the random detector's rows
    reach the evaluator. Then ``--resume`` to 35 iterations and
    ``--eval-only`` from ``model_0000029.pth``, which is copied to ``keep``
    (phase 22 starts from it). Last, ``TF32_ITERS`` float32 iterations (AMP
    off) with TF32 off and with PyTorch's default, TF32 convolutions (the
    training CLIs leave it). Kernel counts are set to 0 just before each run
    and read just after."""
    import json
    import math
    import os
    import tempfile

    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.data import native_io
    from lvc_tpu_torch.evaluation import fast_eval_api
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.tools import train_net
    from lvc_tpu_torch.utils.init import damped_init

    n_train, n_test = TRAIN_NET_TREE
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        t0 = time.perf_counter()
        write_coco_tree(root, n_train, n_test, sizes=((480, 640), (640, 480)), seed=0, max_boxes=8)
        use_coco_tree(root)
        tree_s = time.perf_counter() - t0
        cfg = get_cfg()
        cfg.merge_from_file(TRAIN_NET_YAML)
        model = damped_init(build_model(cfg), seed=0)
        weights = DetectionCheckpointer(model, os.path.join(tmp, "weights")).save("damped_init", iteration=0)
        del model
        out = os.path.join(tmp, "out")
        opts = ["MODEL.WEIGHTS", weights, "SOLVER.AMP.ENABLED", "True", "SOLVER.BASE_LR", "1e-4",
                "SOLVER.CHECKPOINT_PERIOD", str(TRAIN_NET_PERIOD), "SEED", "0",
                "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.001", "OUTPUT_DIR", out]
        yaml = ["--config-file", TRAIN_NET_YAML]

        # 1. training, checkpoints, the final evaluation
        torch.cuda.reset_peak_memory_stats()
        res, secs, (_, k2, k3), trainer = run_cli(train_net, yaml + opts + ["SOLVER.MAX_ITER", str(TRAIN_NET_ITERS)])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if trainer.cfg.SOLVER.IMS_PER_BATCH != 16 or trainer.cfg.MODEL.ROI_HEADS.POOLER_IMPL != "auto":
            raise AssertionError("the phase must run the config's IMS_PER_BATCH 16 and POOLER_IMPL auto")
        with open(os.path.join(out, "metrics.json")) as f:
            rows = [json.loads(line) for line in f]
        losses = {k: v for r in rows for k, v in r.items() if k.startswith(("loss", "total"))}
        if not rows or len(losses) < 5 or not all(math.isfinite(v) for r in rows for k, v in r.items()
                                                  if k.startswith(("loss", "total"))):
            raise AssertionError(f"metrics.json: non-finite or missing losses in {rows}")
        saved = [f"model_{TRAIN_NET_PERIOD - 1:07d}.pth", f"model_{TRAIN_NET_ITERS - 1:07d}.pth"]
        for name in saved + ["last_checkpoint"]:
            if not os.path.exists(os.path.join(out, name)):
                raise AssertionError(f"{name} was not written")
        with open(os.path.join(out, "inference", "res_final.json")) as f:
            final = json.load(f)
        # read now: the resumed run's evaluation overwrites the result rows
        final_rows = result_rows(os.path.join(out, "inference", "coco_instances_test_results.json"))
        ap = final["bbox"]["AP"]
        if not math.isfinite(ap) or ap < 0:
            raise AssertionError(f"res_final.json holds no finite bbox AP: {final}")
        if (k2, k3) != (TRAIN_NET_ITERS + n_test, TRAIN_NET_ITERS):
            raise AssertionError(f"K2/K3 launched {k2}/{k3} times; want {TRAIN_NET_ITERS + n_test}/{TRAIN_NET_ITERS}")
        ms = train_net_report(f"train_net: R-50-FPN base (60 classes) AMP, IMS_PER_BATCH 16 at 832x1344 (tree "
                              f"written in {tree_s:.1f} s)", trainer, secs, peak, 16, tag)
        print(f"train_net: final losses {rows[-1]['total_loss']:.4f} total; checkpoints {', '.join(saved)}, "
              f"last_checkpoint; res_final.json bbox {final['bbox']}; K2/K3 launches "
              f"{k2}/{k3} ({TRAIN_NET_ITERS} steps + {n_test} test images / {TRAIN_NET_ITERS} steps); final "
              f"eval {trainer.test_s:.2f} s for {n_test} images {tag}")
        print(f"train_net: native image I/O {'built' if native_io.available() else 'not built (PIL)'}, "
              f"native COCOeval {'built' if fast_eval_api._load_lib() else 'not built (python)'} {tag}")
        profile_call(trainer.run_step, ms, "train_net iteration (loader wait, B=16 AMP step)", tag,
                     stages=TRAIN_STAGES)

        # 2. resume
        res2, secs2, (_, k2, k3), resumed = run_cli(
            train_net, yaml + ["--resume"] + opts + ["SOLVER.MAX_ITER", str(TRAIN_NET_RESUMED)])
        start = resumed.start_iter
        extra = TRAIN_NET_RESUMED - TRAIN_NET_ITERS
        if start != TRAIN_NET_ITERS or (k2, k3) != (extra + n_test, extra):
            raise AssertionError(f"--resume started at {start} with K2/K3 {k2}/{k3}")
        print(f"train_net --resume: started at iteration {start}, ran to {TRAIN_NET_RESUMED} in {secs2:.1f} s, "
              f"K2/K3 launches {k2}/{k3}, bbox AP {res2['bbox']['AP']:.4f} {tag}")

        # 3. eval-only from the checkpoint the first run evaluated: one model, one device and one set of
        # inputs, so its result rows must be the final evaluation's (a random detector's AP is 0 either way)
        eval_out = os.path.join(tmp, "eval")
        eval_opts = opts[:opts.index("OUTPUT_DIR")] + ["OUTPUT_DIR", eval_out]
        eval_opts[1] = os.path.join(out, saved[1])
        res3, secs3, (_, k2, k3), evaluator = run_cli(train_net, yaml + ["--eval-only"] + eval_opts)
        want = final_rows
        got = result_rows(os.path.join(eval_out, "inference", "coco_instances_test_results.json"))
        if len(want) != len(got) or len(want) < 100:
            raise AssertionError(f"--eval-only: {len(got)} result rows; the final evaluation wrote {len(want)}")
        box_err = score_err = 0.0
        for w, g in zip(want, got):
            if (w["image_id"], w["category_id"]) != (g["image_id"], g["category_id"]):
                raise AssertionError(f"--eval-only result rows differ: {g} vs {w}")
            box_err = max(box_err, max(abs(a - b) for a, b in zip(w["bbox"], g["bbox"])))
            score_err = max(score_err, abs(w["score"] - g["score"]))
        err = max(abs(res3["bbox"][k] - v) for k, v in final["bbox"].items())
        if (k2, k3) != (n_test, 0) or box_err > 1e-3 or score_err > 1e-6 or err > 1e-9:
            raise AssertionError(f"--eval-only: K2/K3 {k2}/{k3}, box err {box_err} px, score err {score_err}, "
                                 f"results {res3['bbox']} vs {final['bbox']}")
        shutil.copy(os.path.join(out, saved[1]), keep)
        print(f"train_net --eval-only {saved[1]}: {len(got)} result rows equal the final evaluation's "
              f"(box err {box_err:.1e} px, tol 1e-3; score err {score_err:.1e}, tol 1e-6), bbox {res3['bbox']} "
              f"equals res_final.json (max diff {err:.1e}); {evaluator.test_s / n_test * 1e3:.2f} ms/img end to "
              f"end at batch 1 (load, decode, resize, forward, COCO rows; {n_test} images), K2 launches {k2} "
              f"{tag}")

        # 4. float32 training (AMP off) with TF32 off and with PyTorch's default, TF32 convolutions:
        # default_setup wrapped to set cuDNN's TF32 for the run
        setup, losses = train_net.default_setup, {}
        for mode in ("TF32 off", "TF32 on"):
            def tf32_setup(cfg, args, on=mode == "TF32 on"):
                seed = setup(cfg, args)
                torch.backends.cudnn.allow_tf32 = on
                return seed

            f32_out = os.path.join(tmp, mode.replace(" ", "_"))
            train_net.default_setup = tf32_setup
            try:
                torch.cuda.reset_peak_memory_stats()
                _, secs, _, trainer = run_cli(train_net, yaml + opts + [
                    "SOLVER.AMP.ENABLED", "False", "SOLVER.MAX_ITER", str(TF32_ITERS), "SOLVER.CHECKPOINT_PERIOD",
                    "1000000", "OUTPUT_DIR", f32_out])
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
            finally:
                train_net.default_setup = setup
                tf32_off()
            if trainer.cfg.SOLVER.AMP.ENABLED:
                raise AssertionError("the float32 runs must not run AMP")
            with open(os.path.join(f32_out, "metrics.json")) as f:
                losses[mode] = [json.loads(line) for line in f][-1]["total_loss"]
            train_net_report(f"train_net float32 {mode}: R-50-FPN base, IMS_PER_BATCH 16 at 832x1344", trainer, secs,
                             peak, 16, tag)
            del trainer
        print(f"train_net float32: total_loss after {TF32_ITERS} iterations {losses['TF32 off']:.6f} with TF32 off, "
              f"{losses['TF32 on']:.6f} with TF32 convolutions {tag}")


# the synthetic-AP gate's iterations a mode: the JAX gate runs 600 in each; cut so that the whole script
# stays well inside its time limit (float32 keeps more: phase 28 evaluates its model)
GATE_ITERS = {"f32": 450, "amp": 400}


def synthetic_ap_gate(tag, keep=None):
    """``lvc_tpu_torch.tools.verify_synthetic_ap`` at ``GATE_ITERS``
    iterations, float32 and AMP: R-50-FPN with GroupNorm trained from the
    damped x0.65 init on drawn shapes (256x256, batch 8), then evaluated on
    its held-out 60 images by the trainer's final evaluation hook. Fails
    unless ``verify_results`` passes (AP50 in (60, 100)) in both modes. The
    float32 model is then evaluated again with TF32 convolutions and matmuls
    and without (``tf32_difference``), and its weights saved to ``keep``
    (phase 28 evaluates it on a VOC tree)."""
    import tempfile

    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.tools import verify_synthetic_ap as gate

    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        gate.register(gate.build_dataset(tmp))
        for mode in ("f32", "amp"):
            ra.roi_align_paired.launches = ra.roi_align_paired_bwd.launches = 0
            bbox, ok, t_train, t_eval, ms_iter, trainer = gate.run_mode(mode, GATE_ITERS[mode], tmp)
            print(f"synthetic AP gate [{mode}]: AP {bbox['AP']:.2f} AP50 {bbox['AP50']:.2f} AP75 "
                  f"{bbox['AP75']:.2f}, {GATE_ITERS[mode]} iterations, train {t_train:.1f} s ({ms_iter:.1f} "
                  f"ms/iter, the median `time` scalar), eval {t_eval:.1f} s of 60 images, verify_results "
                  f"{'PASS' if ok else 'FAIL'}; K2/K3 launches {ra.roi_align_paired.launches}/"
                  f"{ra.roi_align_paired_bwd.launches} {tag}")
            if not ok:
                failures.append(mode)
            if mode == "f32":
                print(tf32_difference(trainer, tmp, tag))
                if keep:
                    import torch

                    torch.save(trainer.model.state_dict(), keep)
            del trainer
    if failures:
        raise AssertionError(f"synthetic AP gate failed in {failures}")


def tf32_difference(trainer, tmp: str, tag):
    """The trained float32 gate model evaluated by its trainer's ``test``
    with PyTorch's default (TF32 convolutions, float32 matmuls) and with
    TF32 off, in that order. The line compares the two evaluations'
    result rows: each row without TF32 against the row of the same image and
    class with the nearest box with TF32; rows whose nearest box is within
    1 px count as the same detection, the rest as moved."""
    import math
    import os

    import torch

    evals = {}
    for mode in ("TF32 on", "TF32 off"):
        cfg = trainer.cfg.clone()
        cfg.defrost()
        cfg.OUTPUT_DIR = os.path.join(tmp, mode.replace(" ", "_"))
        torch.backends.cudnn.allow_tf32 = mode == "TF32 on"
        try:
            t0 = time.perf_counter()
            res = type(trainer).test(cfg, trainer.model)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            tf32_off()
        evals[mode] = res, result_rows(os.path.join(cfg.OUTPUT_DIR, "inference",
                                                    "coco_instances_test_results.json")), secs
    (r_on, rows_on, s_on), (r_off, rows_off, s_off) = evals["TF32 on"], evals["TF32 off"]
    groups = {}
    for row in rows_on:
        groups.setdefault((row["image_id"], row["category_id"]), []).append(row)
    box_err, score_err, moved = 0.0, 0.0, 0
    for row in rows_off:
        near = min(groups.get((row["image_id"], row["category_id"]), []), default=None,
                   key=lambda o: max(abs(x - y) for x, y in zip(o["bbox"], row["bbox"])))
        d = math.inf if near is None else max(abs(x - y) for x, y in zip(near["bbox"], row["bbox"]))
        if d > 1.0:
            moved += 1
            continue
        box_err = max(box_err, d)
        score_err = max(score_err, abs(near["score"] - row["score"]) / row["score"])
    ap_err = max((abs(r_on["bbox"][k] - v) for k, v in r_off["bbox"].items() if math.isfinite(v)), default=math.nan)
    return (f"synthetic AP gate [f32] model evaluated (60 images) with TF32 convolutions (PyTorch's default) {s_on:.2f} s, "
            f"{len(rows_on)} rows, AP {r_on['bbox']['AP']:.4f} AP50 {r_on['bbox']['AP50']:.4f}; without TF32 "
            f"{s_off:.2f} s, {len(rows_off)} rows, AP {r_off['bbox']['AP']:.4f} AP50 {r_off['bbox']['AP50']:.4f}; of "
            f"the rows without TF32, {len(rows_off) - moved} have a row with TF32 within 1 px (max box diff "
            f"{box_err:.3e} px, max score rel diff {score_err:.3e}) and {moved} do not; max AP diff {ap_err:.3e} {tag}")


# ---------------------------------------------------------------------------
# The box corrector (Correct): proposal extraction, cascade UBBR training
# (train_net_reg) and candidate correction (train_net_reg_qe)
# ---------------------------------------------------------------------------

UBBR_YAML = "configs/COCO-detection/cascade_ubbr_R_50_FPN_base.yaml"


def corrector_cfg(device: str):
    """The cascade UBBR config as it stands (3 stages, BoxOnlyLayersCascade,
    NUM_FC 3, RBG) at the narrow widths of ``narrow_cfg``, float32,
    POOLER_IMPL pallas: K2 forward and K3 backward on the card, their plain
    versions on the CPU."""
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(UBBR_YAML)
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.MODEL.ROI_HEADS.POOLER_IMPL = "pallas"
    cfg.MODEL.DEVICE = device
    return cfg


def corrector_inputs():
    """The narrow corrector on the CPU with calibrated weights (its stages'
    regressors scaled so that they move boxes by pixels), a seeded batch of
    2 images (valid gts not contiguous in one), RBG draws, and the slots
    the base sampler picks from the RBG proposals of those draws: (model,
    batch, draws, sampled), all on the CPU."""
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.modeling.proposal_generator.rbg import rbg_proposals

    cpu = build_model(corrector_cfg("cpu"), device="cpu")
    calibrated_init(cpu, seed=0)
    with torch.no_grad():
        for name, t in cpu.state_dict().items():
            if ".bbox_pred.weight" in name:
                t.mul_(0.02)
    batch = train_batch(2, 128, 192, 6, seed=5, device="cpu", num_classes=60, n_gt=(2, 5), size=(16, 90))
    batch["gt_valid"][1, 0] = False
    rbg = cpu.proposal_generator
    draws = rbg.draws(2, torch.Generator().manual_seed(1), "cpu")
    props = rbg_proposals(batch["gt_boxes"], batch["gt_valid"], batch["image_size"], *draws, rbg.t)
    sampled = cpu.roi_heads.label_and_sample_proposals(
        props[0], props[2], batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"], None,
        torch.Generator().manual_seed(2))
    return cpu, batch, draws, sampled


def corrector_reference_check(tag):
    """The corrector card vs CPU at float32 from the same weights (the
    calibrated init, the stage heads' regressors scaled so that the stages
    move their boxes): one training step's forward and backward with the
    same RBG draws and the same sampled slots (drawn once on the CPU), each
    stage's loss to rel 1e-4 and every parameter gradient of the box heads
    and the FPN outputs to rel L2 1e-4; reg-only inference on seeded jittered
    candidates, boxes within 1e-3 px; ``ProposalNetwork``'s proposals within
    1e-3 px at every slot whose objectness is 1e-4 or more from its
    neighbours' (away from near-ties). K2/K3 launch counts of each card
    run: 3/3, 3/0 and 0/0."""
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.modeling.proposal_generator.rbg import rbg_proposals
    from lvc_tpu_torch.modeling.roi_heads.roi_heads import SampledProposals
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.tools.train_net_reg import jitter_candidates, reg_only_model

    cfg = corrector_cfg("cpu")
    cpu, batch, draws, sampled = corrector_inputs()
    gpu = build_model(corrector_cfg("cuda"))
    gpu.load_state_dict(cpu.state_dict())
    gt = {"boxes": batch["gt_boxes"], "classes": batch["gt_classes"], "valid": batch["gt_valid"]}
    rbg_t = cpu.proposal_generator.t
    heads = ("roi_heads.", "backbone.fpn_output")
    res = {}
    for key, model in (("cpu", cpu), ("gpu", gpu)):
        dev = model.device
        ra.roi_align_paired.launches = ra.roi_align_paired_bwd.launches = 0
        model.train()
        model.zero_grad(set_to_none=True)
        on = {k: v.to(dev) for k, v in gt.items()}
        p = rbg_proposals(on["boxes"], on["valid"], batch["image_size"].to(dev), *(d.to(dev) for d in draws), rbg_t)
        features = model.backbone(model.model_images(batch))
        losses = model.roi_heads.cascade_losses(
            features, SampledProposals(*(t.to(dev) for t in sampled)), on, batch["image_size"].to(dev))
        sum(losses.values()).backward()
        grads = {n: q.grad.detach().cpu().double() for n, q in model.named_parameters()
                 if n.startswith(heads) and q.grad is not None}
        train_n = ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches
        model.eval()
        cands = torch.from_numpy(jitter_candidates(np.random.RandomState(0), batch["gt_boxes"].numpy(),
                                                   batch["gt_valid"].numpy()))
        ra.roi_align_paired.launches = ra.roi_align_paired_bwd.launches = 0
        out = reg_only_model(cfg, model)(dict(batch, gt_boxes=cands))
        reg_n = ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches
        res[key] = ([t.cpu() for t in p], {k: float(v.detach()) for k, v in losses.items()}, grads,
                    [t.cpu() for t in out], train_n, reg_n)
    (c_p, c_loss, c_grad, c_out, _, _), (g_p, g_loss, g_grad, g_out, g_train_n, g_reg_n) = res["cpu"], res["gpu"]
    rbg_err = float((c_p[0] - g_p[0]).abs().max())
    if not torch.equal(c_p[2], g_p[2]) or rbg_err > 1e-4:
        raise AssertionError(f"RBG proposals differ: validity or box err {rbg_err}")
    loss_err = max(abs(g_loss[k] - v) / max(abs(v), 1e-30) for k, v in c_loss.items())
    if set(c_loss) != {f"loss_box_reg_stage{k}" for k in range(3)} or set(g_loss) != set(c_loss) \
            or loss_err > 1e-4 or min(c_loss.values()) <= 0:
        raise AssertionError(f"corrector losses differ: cpu {c_loss} card {g_loss}")
    rel = {n: float((g_grad[n] - w).norm() / w.norm().clamp(min=1e-30)) for n, w in c_grad.items()}
    worst = max(rel, key=rel.get)
    if set(c_grad) != set(g_grad) or len(rel) < 20 or rel[worst] > 1e-4:
        raise AssertionError(f"corrector grads differ: {worst} rel L2 {rel[worst]} over {len(rel)}")
    v = c_out[2]
    reg_err = float((c_out[0][v] - g_out[0][v]).abs().max())
    moved = float((c_out[0][v] - torch.from_numpy(jitter_candidates(
        np.random.RandomState(0), batch["gt_boxes"].numpy(), batch["gt_valid"].numpy()))[v]).abs().max())
    if not torch.equal(v, g_out[2]) or int(v.sum()) < 4 or reg_err > 1e-3 or moved <= 0:
        raise AssertionError(f"reg-only boxes differ: {reg_err} px (moved {moved} px)")
    if g_train_n != (3, 3) or g_reg_n != (3, 0):
        raise AssertionError(f"K2/K3 launches: training step {g_train_n} (want 3/3), reg-only {g_reg_n} (want 3/0)")

    pcfg = narrow_cfg("pallas")
    pcfg.MODEL.META_ARCHITECTURE = "ProposalNetwork"
    pcfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
    pcfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
    weights = build_model(pcfg, device="cpu")
    calibrated_init(weights, seed=0)
    pn = []
    for dev in ("cpu", "cuda"):
        model = build_model(pcfg, device=dev)
        model.load_state_dict(weights.state_dict())
        ra.roi_align_paired.launches = 0
        pn.append(({k: t.cpu() for k, t in model(batch).items()}, ra.roi_align_paired.launches))
    (c, _), (g, g_n) = pn
    logits = c["objectness_logits"]
    gap = torch.full_like(logits, float("inf"))
    gap[:, 1:] = (logits[:, 1:] - logits[:, :-1]).abs()
    gap[:, :-1] = torch.minimum(gap[:, :-1], (logits[:, :-1] - logits[:, 1:]).abs())
    clear = c["proposal_valid"] & g["proposal_valid"] & (gap > 1e-4)
    prop_err = float((c["proposal_boxes"][clear] - g["proposal_boxes"][clear]).abs().max())
    if int(clear.sum()) < 0.9 * int(c["proposal_valid"].sum()) or prop_err > 1e-3 or g_n != 0:
        raise AssertionError(f"ProposalNetwork: {int(clear.sum())} clear slots, box err {prop_err}, K2 {g_n}")
    print(f"corrector reference: card vs CPU at float32, narrow cascade UBBR (3 stages, BoxOnlyLayersCascade, "
          f"NUM_FC 3); RBG from the same draws {int(c_p[2].sum())} kept, box err {rbg_err:.2e} (tol 1e-4); "
          f"stage losses {c_loss} max rel err {loss_err:.2e} (tol 1e-4); {len(rel)} box-head and FPN-output "
          f"grads max rel L2 {rel[worst]:.2e} ({worst}; tol 1e-4); reg-only {int(v.sum())} candidates moved up to "
          f"{moved:.3f} px, card vs CPU {reg_err:.2e} px (tol 1e-3); ProposalNetwork {int(clear.sum())} clear "
          f"slots box err {prop_err:.2e} px (tol 1e-3); card K2/K3 launches: training step {g_train_n[0]}/"
          f"{g_train_n[1]}, reg-only {g_reg_n[0]}/{g_reg_n[1]}, ProposalNetwork {g_n}/0 {tag}")


class PoolRecorder:
    """While in use, stands in for K1's, K2's and K3's wrappers in
    ``ops.roi_align``: keeps the arguments of every call the path makes (a
    copy of K3's gout) and passes the call on to the wrapper."""

    def __init__(self):
        from lvc_tpu_torch.ops import roi_align as ra

        self.ra, self.band, self.fwd, self.bwd = ra, [], [], []
        self.k1, self.k2, self.k3 = ra.roi_align_band, ra.roi_align_paired, ra.roi_align_paired_bwd

    def band_forward(self, levels, taps):
        self.band.append((list(levels), taps))
        return self.k1(levels, taps)

    def forward(self, levels, taps):
        self.fwd.append((list(levels), taps))
        return self.k2(levels, taps)

    def backward(self, level_shapes, taps, gout):
        self.bwd.append((list(level_shapes), taps, gout.clone()))
        return self.k3(level_shapes, taps, gout)

    def __enter__(self):
        self.ra.roi_align_band = self.band_forward
        self.ra.roi_align_paired, self.ra.roi_align_paired_bwd = self.forward, self.backward
        return self

    def __exit__(self, *exc):
        self.ra.roi_align_band, self.ra.roi_align_paired, self.ra.roi_align_paired_bwd = self.k1, self.k2, self.k3


def check_recorded_pool(what, rec, tag, timed=False):
    """K1, K2 and K3 on the very tensors a run of the path gave them
    (recorded by ``PoolRecorder``), against their plain versions on the same
    tensors on the card, at the tolerances of the card tests: K2 bit for
    bit; K1 within 1e-5 * S of the plain sums (S: the plain pool of |levels|
    with |weights|; plus 1 bf16 ulp for bf16: its band sums run in another
    order); K3 within 1e-5 * S of the plain float32 sums (S: the plain
    backward on |gout| and |weights|; plus 1 bf16 ulp of the cast for bf16),
    two calls bit-equal. Kernel counts are set to 0 just before and must
    read one launch per call (two per K3 call) just after. ``timed``: each
    kernel's ms on its first recorded call, beside its plain version's ms
    and its bound; returns {kernel: (ms, plain_ms, bound_ms, bound_by)}."""
    import torch

    ra = rec.ra
    k1, k2, k3 = ra.roi_align_band, ra.roi_align_paired, ra.roi_align_paired_bwd
    k1.launches = k2.launches = k3.launches = 0
    fwd, k1_ratio = [], 0.0
    rec.max_err = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    for kernel, calls in ((k1, rec.band), (k2, rec.fwd)):
        for levels, taps in calls:
            got = kernel(levels, taps)
            want = ra.roi_align_taps_plain(levels, taps, kernel.paired)
            if kernel is k2:
                ok = torch.equal(got, want)
            else:
                S = ra.roi_align_taps_plain([f.abs() for f in levels], taps._replace(
                    wy=taps.wy.abs(), wx=taps.wx.abs()), False).float()
                err = (got.float() - want.float()).abs()
                ok = bool((err <= 1e-5 * S + (bf16_ulp(want.float()) if got.dtype == torch.bfloat16 else 0.0)).all())
                k1_ratio = max(k1_ratio, float((err / S.clamp(min=1e-30)).max()))
            if not torch.isfinite(got).all() or not ok:
                raise AssertionError(f"{what}: {'K2' if kernel is k2 else 'K1'} differs from its plain version, "
                                     f"max abs err {float((got.float() - want.float()).abs().max())}")
            key = "K2" if kernel is k2 else "K1"
            rec.max_err[key] = max(rec.max_err[key], float((got.float() - want.float()).detach().abs().max()))
            n, P, NR = taps.rows.shape
            fwd.append(f"{'K2' if kernel is k2 else 'K1'} {n} boxes P={P} NR={NR} NT={taps.tcol.shape[-1]}")
    max_ratio, max_err = 0.0, 0.0
    for level_shapes, taps, gout in rec.bwd:
        got, again = k3(level_shapes, taps, gout), k3(level_shapes, taps, gout)
        want = ra.roi_align_taps_plain_backward(level_shapes, taps, gout)
        S = ra.roi_align_taps_plain_backward(
            level_shapes, taps._replace(wy=taps.wy.abs(), wx=taps.wx.abs()), gout.abs())
        for l, (a, b, w, s) in enumerate(zip(got, again, want, S)):
            ref = w.to(gout.dtype).float()
            err = (a.float() - ref).abs()
            tol = 1e-5 * s + (bf16_ulp(ref) if gout.dtype == torch.bfloat16 else 0.0)
            if a.dtype != gout.dtype or not torch.isfinite(a).all() or not bool((err <= tol).all()) \
                    or not torch.equal(a, b):
                raise AssertionError(f"{what}: K3 level {l} over 1e-5 * S or two calls differ")
            max_err = max(max_err, float(err.max()))
            rec.max_err["K3"] = max_err
            max_ratio = max(max_ratio, float((err / s.clamp(min=1e-30)).max()))
        del got, again, want, S
    n = k1.launches, k2.launches, k3.launches
    if n != (len(rec.band), len(rec.fwd), 2 * len(rec.bwd)) or not (rec.fwd or rec.band):
        raise AssertionError(f"{what}: K1/K2/K3 launches {n} for {len(rec.band)}/{len(rec.fwd)}/{len(rec.bwd)} "
                             f"recorded calls")
    levels = (rec.fwd or rec.band)[0][0]
    k1_part = f"K1 max err/S {k1_ratio:.3e} (tol 1e-5 * S); " if rec.band else ""
    ulp = " + 1 bf16 ulp" if rec.bwd and rec.bwd[0][2].dtype == torch.bfloat16 else ""
    k3_part = (f"K3 on {len(rec.bwd)} calls max abs err {max_err:.3e} max err/S {max_ratio:.3e} (tol 1e-5 * S{ulp}), "
               f"two calls bit-equal; " if rec.bwd else "")
    print(f"{what}: the path's own kernel inputs (levels {[tuple(f.shape) for f in levels]} {levels[0].dtype}) "
          f"against the plain versions on the card: {'; '.join(fwd)}; K2 bit-equal; {k1_part}{k3_part}"
          f"launches K1/K2/K3 {n[0]}/{n[1]}/{n[2]} {tag}")
    if not timed:
        return {}
    times = {}
    for name, kernel, calls in (("K1", k1, rec.band), ("K2", k2, rec.fwd)):
        if calls:
            levels, taps = calls[0]
            ms = cuda_ms(lambda: kernel(levels, taps), 20)
            plain_ms = cuda_ms(lambda: ra.roi_align_taps_plain(levels, taps, kernel.paired), 2)
            times[name] = (ms, plain_ms) + bound(levels, taps)[:2]
    if rec.bwd:
        level_shapes, taps, gout = rec.bwd[0]
        ms = cuda_ms(lambda: k3(level_shapes, taps, gout), 20)
        plain_ms = cuda_ms(lambda: ra.roi_align_taps_plain_backward(level_shapes, taps, gout), 1)
        times["K3"] = (ms, plain_ms) + backward_bound(level_shapes, taps, gout)[:2]
    k1.launches = k2.launches = k3.launches = 0
    for name, (ms, plain_ms, bound_ms, bound_by) in times.items():
        print(f"{what}: {name} {ms:.4f} ms (plain {plain_ms:.3f} ms), bound {bound_ms:.4f} ms ({bound_by}), "
              f"share {bound_ms / ms:.3f} {tag}")
    return times


def write_candidates(src_json: str, out_json: str, keep_ids, seed: int = 0) -> int:
    """The annotations of ``src_json`` whose category is in ``keep_ids``,
    each box jittered as ``jitter_candidates`` jitters (alpha 0.25, beta
    0.3) and clipped to its image, with a score, as a COCO dict that
    ``register_results`` reads. Returns the number of candidates."""
    import json

    import numpy as np

    with open(src_json) as f:
        data = json.load(f)
    rng = np.random.RandomState(seed)
    sizes = {im["id"]: (im["height"], im["width"]) for im in data["images"]}
    anns = []
    for a in data["annotations"]:
        if a["category_id"] not in keep_ids:
            continue
        x, y, w, h = a["bbox"]
        tx, ty = rng.uniform(-0.25, 0.25, 2)
        tw, th = np.exp(rng.uniform(np.log(0.7), np.log(1.3), 2))
        H, W = sizes[a["image_id"]]
        x0, y0 = min(max(x + w * tx, 0.0), W - 2.0), min(max(y + h * ty, 0.0), H - 2.0)
        x1, y1 = min(x0 + w * tw, float(W)), min(y0 + h * th, float(H))
        anns.append(dict(a, bbox=[x0, y0, x1 - x0, y1 - y0], area=(x1 - x0) * (y1 - y0),
                         score=float(rng.uniform(0.8, 1.0))))
    with open(out_json, "w") as f:
        json.dump(dict(data, annotations=anns), f)
    return len(anns)


def correct_path(tag, keep: str):
    """The correct path at full width through the three CLIs, in this
    process, on phase 17's seeded COCO tree (48 train and 16 test JPEGs of
    480x640 and 640x480), from a damped-init R-50-FPN ``.pth``:
    1. ``train_net --eval-only MODEL.META_ARCHITECTURE ProposalNetwork`` on
       the test and trainval splits: both proposal pickles, AR, ms/img;
    2. ``train_net_reg`` on cascade_ubbr_R_50_FPN_base.yaml as it stands
       (R-50-FPN, FREEZE_AT 2, 60 classes, 3 cascade stages of
       BoxOnlyLayersCascade, IOUS 0.3/0.5/0.7, NUM_FC 3, RBG, 64 slots per
       image at POSITIVE_FRACTION 1.0, crop 0.8, IMS_PER_BATCH 16 at
       832x1344, float32, POOLER_IMPL auto) with the trainval proposal file,
       30 iterations with a checkpoint every 15, then its IoU test on the
       test split: ms/iter and img/s over the steps after warm-up,
       data_time, peak memory, one profiled iteration, K2/K3 launches per
       step (3/3) and per test batch (3/0), iou_in/iou_out; then K2 and K3
       on one more step's own tensors (16 x 64 slots a stage, float32,
       C=256) and K2 on one reg-only test batch's candidate slots, each
       against its plain version on the same tensors;
    3. ``train_net_reg_qe --resume --eval-only`` on jittered candidates of
       the test split's gt (the classes the 60-class corrector covers): one
       row per candidate, ids preserved, finite boxes inside their images,
       K2 launches 3 per image, ms/img.
    The corrector's last checkpoint is copied to ``keep`` (phase 22 starts
    from it). Kernel counts are set to 0 just before each CLI and read just
    after."""
    import json
    import math
    import os
    import pickle
    import tempfile

    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    import numpy as np

    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.data.build import build_detection_test_loader
    from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.tools import train_net, train_net_reg, train_net_reg_qe
    from lvc_tpu_torch.utils.init import damped_init

    n_train, n_test = TRAIN_NET_TREE
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        write_coco_tree(root, n_train, n_test, sizes=((480, 640), (640, 480)), seed=0, max_boxes=8)
        use_coco_tree(root)
        cfg = get_cfg()
        cfg.merge_from_file(TRAIN_NET_YAML)
        weights = DetectionCheckpointer(damped_init(build_model(cfg), seed=0), os.path.join(tmp, "w")).save(
            "damped_init", iteration=0)

        # 1. proposal extraction
        det = os.path.join(tmp, "det")
        res, secs, (_, k2, k3), _ = run_cli(train_net, [
            "--eval-only", "--config-file", TRAIN_NET_YAML, "MODEL.WEIGHTS", weights, "MODEL.META_ARCHITECTURE",
            "ProposalNetwork", "DATASETS.TEST", "('coco_test_base', 'coco_trainval_base')", "OUTPUT_DIR", det])
        pkls = {}
        for split, n_img in (("trainval", n_train), ("test", n_test)):
            with open(os.path.join(det, f"coco_proposals_{split}_results.pkl"), "rb") as f:
                pkls[split] = pickle.load(f)
            p = pkls[split]
            if len(p["ids"]) != n_img or any(len(b) == 0 or not (b == b).all() for b in p["boxes"]):
                raise AssertionError(f"coco_proposals_{split}_results.pkl: {len(p['ids'])} images")
        ar = res["coco_test_base"]["bbox"]
        if (k2, k3) != (0, 0) or not all(math.isfinite(v) and 0 <= v <= 100 for v in ar.values()):
            raise AssertionError(f"ProposalNetwork: K2/K3 {k2}/{k3}, AR {ar}")
        print(f"train_net ProposalNetwork --eval-only: R-50-FPN, {n_train + n_test} images in {secs:.1f} s, "
              f"{secs / (n_train + n_test) * 1e3:.2f} ms/img end to end at batch 1 (load, decode, resize, forward, "
              f"proposals to the host; model build and weight load included); proposals per image "
              f"{min(len(b) for b in pkls['test']['boxes'])}-{max(len(b) for b in pkls['test']['boxes'])}; "
              f"test AR {ar} (a damped-init RPN) {tag}")

        # 2. corrector training and its IoU test
        ub = os.path.join(tmp, "ubbr")
        opts = ["--config-file", UBBR_YAML, "MODEL.WEIGHTS", weights, "SEED", "0",
                "DATASETS.PROPOSAL_FILES_TRAIN", f"('{det}/coco_proposals_trainval_results.pkl',)",
                "DATASETS.PROPOSAL_FILES_TEST", f"('{det}/coco_proposals_test_results.pkl',)",
                "SOLVER.CHECKPOINT_PERIOD", str(TRAIN_NET_PERIOD), "SOLVER.MAX_ITER", str(TRAIN_NET_ITERS),
                "OUTPUT_DIR", ub]
        torch.cuda.reset_peak_memory_stats()
        res, secs, _, trainer = run_cli(train_net_reg, opts, "RegTrainer")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        c = trainer.cfg
        if (c.SOLVER.IMS_PER_BATCH, c.MODEL.ROI_HEADS.POOLER_IMPL, c.SOLVER.AMP.ENABLED, c.MODEL.ROI_HEADS.NAME,
                c.MODEL.ROI_HEADS.OUTPUT_LAYER, c.MODEL.PROPOSAL_GENERATOR.NAME) != (
                16, "auto", False, "CascadeROIHeads", "BoxOnlyLayersCascade", "RBG"):
            raise AssertionError("the phase must run cascade_ubbr_R_50_FPN_base.yaml as it stands")
        with open(os.path.join(ub, "metrics.json")) as f:
            rows = [json.loads(line) for line in f]
        losses = {k for r in rows for k in r if k.startswith("loss_box_reg_stage")}
        if len(losses) != 3 or not all(math.isfinite(r[k]) for r in rows for k in losses if k in r):
            raise AssertionError(f"metrics.json: stage losses {rows}")
        for name in (f"model_{TRAIN_NET_PERIOD - 1:07d}.pth", f"model_{TRAIN_NET_ITERS - 1:07d}.pth",
                     "last_checkpoint"):
            if not os.path.exists(os.path.join(ub, name)):
                raise AssertionError(f"{name} was not written")
        ubbr = res["ubbr"]
        train_n, test_n = tuple(map(sum, zip(*trainer.step_launches))), trainer.test_launches
        if train_n != (3 * TRAIN_NET_ITERS, 3 * TRAIN_NET_ITERS) or test_n != (3 * n_test, 0):
            raise AssertionError(f"K2/K3 launches: training {train_n}, test {test_n}")
        if not ubbr["per_class"] or not all(0 <= v["iou_in"] <= 1 and 0 <= v["iou_out"] <= 1
                                            for v in ubbr["per_class"].values()):
            raise AssertionError(f"IoU test: {ubbr}")
        ms = train_net_report("train_net_reg: cascade UBBR R-50-FPN base (60 classes, 3 stages, RBG 128 slots, 64 "
                              "sampled per image), float32, IMS_PER_BATCH 16 at 832x1344", trainer, secs, peak, 16, tag)
        print(f"train_net_reg: final losses { {k: round(rows[-1][k], 4) for k in sorted(losses)} }; K2/K3 launches "
              f"{train_n[0] // TRAIN_NET_ITERS}/{train_n[1] // TRAIN_NET_ITERS} per training step, "
              f"{test_n[0] // n_test}/{test_n[1]} per test batch of 1; IoU test on "
              f"{sum(v['n'] for v in ubbr['per_class'].values())} jittered test gts in {trainer.test_s:.2f} s: "
              f"mean iou_in {ubbr['mean_iou_in']:.4f} iou_out {ubbr['mean_iou_out']:.4f} {tag}")
        profile_call(trainer.run_step, ms, "train_net_reg iteration (loader wait, B=16 float32 step)", tag,
                     stages=TRAIN_STAGES)

        # the kernels on one training step's and one reg-only batch's own
        # tensors: the three stages' boxes at 16 x 64 slots over the float32
        # C=256 pyramid, then the candidate slots of one test image
        with PoolRecorder() as rec:
            trainer.run_step()
        if len(rec.fwd) != 3 or len(rec.bwd) != 3 or rec.fwd[0][1].rows.shape[0] != 16 * 64:
            raise AssertionError(f"recorded step: {len(rec.fwd)}/{len(rec.bwd)} pool calls")
        check_recorded_pool("train_net_reg step", rec, tag)
        del rec
        reg = train_net_reg.reg_only_model(c, trainer.model)
        batches = iter(build_detection_test_loader(c, c.DATASETS.TEST[0], batch_size=1, with_gt=True))
        batch, _ = next(batches)
        batches.close()
        cands = train_net_reg.jitter_candidates(np.random.RandomState(0), batch["gt_boxes"], batch["gt_valid"])
        with PoolRecorder() as rec, torch.no_grad():
            reg(dict(batch, gt_boxes=cands))
        if len(rec.fwd) != 3 or rec.bwd or rec.fwd[0][1].rows.shape[0] != c.PAD.MAX_GT_PER_IMAGE:
            raise AssertionError(f"recorded reg-only batch: {len(rec.fwd)}/{len(rec.bwd)} pool calls")
        check_recorded_pool("train_net_reg reg-only batch", rec, tag)
        del rec, reg

        shutil.copy(os.path.join(ub, f"model_{TRAIN_NET_ITERS - 1:07d}.pth"), keep)

        # 3. candidate correction
        meta = _get_builtin_metadata("coco_fewshot")
        covered = {k for k, v in meta["thing_dataset_id_to_contiguous_id"].items() if v < 60}
        cands = os.path.join(tmp, "candidates.json")
        n_cand = write_candidates(os.path.join(root, "cocosplit", "datasplit", "5k.json"), cands, covered)
        res, secs, (_, *n), _ = run_cli(train_net_reg_qe, [
            "--resume", "--eval-only", "--config-file", UBBR_YAML, "OUTPUT_DIR", ub, "DATASETS.TRAIN",
            "('coco_test_base',)", "DATASETS.DT_PATH", f"('{cands}',)", "MODEL.LOAD_PROPOSALS", "False",
            "QUERY_EXPAND.ENABLED", "True"], trainer=None)
        with open(cands) as f:
            src = json.load(f)
        with open(cands.replace(".json", "_ubbr.json")) as f:
            out = json.load(f)
        sizes = {im["id"]: (im["height"], im["width"]) for im in src["images"]}
        want = {a["id"]: a for a in src["annotations"]}
        if len(out) != n_cand or sorted(r["id"] for r in out) != sorted(want):
            raise AssertionError(f"_ubbr.json: {len(out)} rows for {n_cand} candidates, ids differ")
        moved = 0.0
        for r in out:
            H, W = sizes[r["image_id"]]
            x, y, w, h = r["bbox"]
            if not all(math.isfinite(v) for v in r["bbox"]) or x < -1e-3 or y < -1e-3 or x + w > W + 1e-3 \
                    or y + h > H + 1e-3 or r["category_id"] != want[r["id"]]["category_id"]:
                raise AssertionError(f"_ubbr.json row {r} (image {H}x{W})")
            moved = max(moved, max(abs(a - b) for a, b in zip(r["bbox"], want[r["id"]]["bbox"])))
        if n != [3 * len(sizes), 0]:
            raise AssertionError(f"train_net_reg_qe: K2/K3 launches {n}; want {3 * len(sizes)}/0")
        print(f"train_net_reg_qe --resume --eval-only: {n_cand} candidates of {len(sizes)} test images corrected "
              f"in {secs:.1f} s, {secs / len(sizes) * 1e3:.2f} ms/img end to end at batch 1 (model build, "
              f"checkpoint load, decode, resize, forward, rows); "
              f"_ubbr.json has one row per candidate with its id, boxes finite and inside their images, moved up "
              f"to {moved:.3f} px; K2/K3 launches {n[0]}/{n[1]} ({n[0] // len(sizes)} per image) {tag}")


# ---------------------------------------------------------------------------
# The LVC chain of scripts/coco_full_run.sh through its twin
# ---------------------------------------------------------------------------

CHAIN_RESPREAD = ("person", "car", "dog", "tv")  # unseen classes the random detector's rows are spread over


def write_chain_tree(root: str, n_train: int, n_test: int, n_unlabeled: int, sizes=((480, 640), (640, 480)),
                     seed: int = 0, max_boxes: int = 8) -> None:
    """The tree every step of the chain reads: ``write_coco_tree`` over all 80
    classes, the 30-shot file of every class
    (``cocosplit/full_box_30shot_<class>_trainval.json``: up to 30 of its
    non-crowd training boxes) and an unlabeled split (JPEGs under
    ``coco/unlabeled2017``, listed without annotations in
    ``coco/annotations/image_info_unlabeled2017.json``)."""
    import json
    import os

    import numpy as np
    from PIL import Image

    from lvc_tpu_torch.data.builtin_meta import COCO_CATEGORIES

    write_coco_tree(root, n_train, n_test, sizes=sizes, seed=seed, max_boxes=max_boxes,
                    category_ids=[c["id"] for c in COCO_CATEGORIES])
    with open(os.path.join(root, "cocosplit", "datasplit", "trainvalno5k.json")) as f:
        gt = json.load(f)
    for c in COCO_CATEGORIES:
        anns = [a for a in gt["annotations"] if a["category_id"] == c["id"] and not a["iscrowd"]][:30]
        ids = {a["image_id"] for a in anns}
        with open(os.path.join(root, "cocosplit", f"full_box_30shot_{c['name']}_trainval.json"), "w") as f:
            json.dump({"images": [im for im in gt["images"] if im["id"] in ids], "annotations": anns,
                       "categories": gt["categories"]}, f)
    rng = np.random.RandomState(seed + 1)
    img_dir = os.path.join(root, "coco", "unlabeled2017")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "coco", "annotations"), exist_ok=True)
    images = []
    for i in range(n_unlabeled):
        H, W = sizes[i % len(sizes)]
        low = rng.randint(0, 200, (H // 16 + 1, W // 16 + 1, 3)).astype(np.uint8)
        img = np.kron(low, np.ones((16, 16, 1), np.uint8))[:H, :W].copy()
        for _ in range(rng.randint(1, max_boxes + 1)):
            w, h = rng.randint(W // 16, W // 2), rng.randint(H // 16, H // 2)
            x, y = rng.randint(0, W - w), rng.randint(0, H - h)
            img[y:y + h, x:x + w] = rng.randint(0, 256, 3)
        name = f"img_{200001 + i:06d}.jpg"
        Image.fromarray(img).save(os.path.join(img_dir, name), quality=90)
        images.append({"id": 200001 + i, "file_name": name, "height": H, "width": W})
    with open(os.path.join(root, "coco", "annotations", "image_info_unlabeled2017.json"), "w") as f:
        json.dump({"images": images, "categories": gt["categories"]}, f)


def respread_detections(path: str, lo: float = 0.6, hi: float = 0.99) -> None:
    """Rewrite a detection file of a random detector, as
    tests/test_lvc_loop_e2e.py does after its stage 10: in order of score,
    the rows take the classes of ``CHAIN_RESPREAD`` in turn and scores
    falling evenly from ``hi`` to ``lo`` (a random detector scores every
    class near 1/81, below the chain's mining band [0.8, 1.0)); boxes, images
    and the file format stay the detector's."""
    import json

    from lvc_tpu_torch.data.builtin_meta import COCO_CATEGORIES

    ids = [next(c["id"] for c in COCO_CATEGORIES if c["name"] == n) for n in CHAIN_RESPREAD]
    with open(path) as f:
        dets = json.load(f)
    dets.sort(key=lambda d: -d["score"])
    for i, d in enumerate(dets):
        d["category_id"] = ids[i % len(ids)]
        d["score"] = hi - (hi - lo) * i / max(len(dets) - 1, 1)
    with open(path, "w") as f:
        json.dump(dets, f)


def repoint_shots(root: str, mined_json: str, n_shots: int) -> int:
    """Rewrite the 30-shot files so that every shot is one of ``n_shots`` kept
    candidates of the class the mining kept most of, and every other class
    has none, as tests/test_lvc_loop_e2e.py does before verifying: the kNN
    vote is then that class for every query, so verification confirms
    exactly its candidates whatever the random descriptors. Returns the
    class's COCO id."""
    import json
    import os
    from collections import Counter

    from lvc_tpu_torch.data.builtin_meta import COCO_CATEGORIES

    with open(mined_json) as f:
        mined = json.load(f)
    kept = [a for a in mined["annotations"] if not a.get("ignore_qe")]
    cls = Counter(a["category_id"] for a in kept).most_common(1)[0][0]
    shots = [a for a in kept if a["category_id"] == cls][:n_shots]
    if len(shots) < n_shots:
        raise AssertionError(f"mining kept {len(shots)} candidates of class {cls}; the shots need {n_shots}")
    with open(os.path.join(root, "cocosplit", "datasplit", "trainvalno5k.json")) as f:
        gt = json.load(f)
    ids = {a["image_id"] for a in shots}
    anns = [{"id": 10 ** 7 + i, "image_id": a["image_id"], "category_id": cls, "bbox": a["bbox"],
             "area": float(a["bbox"][2] * a["bbox"][3]), "iscrowd": 0} for i, a in enumerate(shots)]
    for c in COCO_CATEGORIES:
        mine = c["id"] == cls
        with open(os.path.join(root, "cocosplit", f"full_box_30shot_{c['name']}_trainval.json"), "w") as f:
            json.dump({"images": [im for im in gt["images"] if im["id"] in ids] if mine else [],
                       "annotations": anns if mine else [], "categories": gt["categories"]}, f)
    return cls


def drive_chain(root: str, work: str, iters: int, weights: str, ubbr_weights=None, opts=(), run=None):
    """Run the 18 steps of ``lvc_tpu_torch.tools.coco_full_run`` with ``work``
    as the working directory, on the tree that ``write_chain_tree`` wrote at
    ``root``, each from the files the steps before it wrote. Before step 11
    both detection files are respread (``respread_detections``), before step
    14 the shots are repointed (``repoint_shots``, 12 shots for the chain's
    KNN 10). ``run(step, go)`` may wrap each step (``go()`` runs it). Returns
    the class the shots were repointed to."""
    import os

    from lvc_tpu_torch.tools import coco_full_run as chain

    run = run or (lambda step, go: go())
    inference = os.path.join(work, chain.FT, "inference")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        chain.use_datasets(root)
        for step in chain.chain(root, iters, weights, ubbr_weights, opts):
            if step.number == "11":
                for split in ("trainval", "unlabeled"):
                    respread_detections(os.path.join(inference, f"coco_instances_{split}_results.json"))
            if step.number == "14 trainval":
                cls = repoint_shots(root, os.path.join(
                    inference, f"coco_instances_trainval_results{chain.MINED}.json"), 12)
            run(step, lambda: chain.run_step(step))
    finally:
        os.chdir(cwd)
    return cls


def check_chain_files(work: str, cls: int, nn_model: str) -> dict:
    """The relations between the files a run of the chain wrote under
    ``work`` (raises AssertionError where one fails): each training run's
    ``model_final.pth`` is its last checkpoint; ``remove`` dropped the box
    predictor and ``combine`` holds 81 classifier rows; both proposal
    pickles exist; per split, the verified candidates are mined ones of the
    shots' class ``cls``, the corrected file has a row (with ``bbox_orig``)
    for each, ``_id.json`` carries the corrected boxes by id, ``_ignore.json``
    keeps exactly them and adds ignore regions; base-class gt was merged;
    the retrain wrote finite losses. Returns the verified and ignore counts."""
    import json
    import os

    import numpy as np
    import torch

    from lvc_tpu_torch.tools import coco_full_run as chain

    def load(path):
        with open(os.path.join(work, path)) as f:
            return json.load(f)

    for d in (chain.BASE, chain.NOVEL, chain.FT, chain.UBBR_BASE, chain.UBBR_FT, chain.RETRAIN):
        with open(os.path.join(work, d, "last_checkpoint")) as f:
            last = os.path.join(work, d, f.read())
        if not os.path.samefile(os.path.join(work, d, "model_final.pth"), last):
            raise AssertionError(f"{d}/model_final.pth is not {last}")
    removed = torch.load(os.path.join(work, chain.BASE, "model_reset_remove.pth"), weights_only=False)["model"]
    combined = torch.load(os.path.join(work, chain.NOVEL, "model_reset_combine.pth"), weights_only=False)["model"]
    if any("box_predictor" in k for k in removed) or combined[
            "roi_heads.box_predictor.cls_score.weight"].shape[0] != 81:
        raise AssertionError("checkpoint surgery: remove kept the predictor or combine lacks 81 rows")
    for d in (chain.BASE, chain.FT):
        for split in ("trainval", "test"):
            if not os.path.exists(os.path.join(work, d, f"coco_proposals_{split}_results.pkl")):
                raise AssertionError(f"{d}: no {split} proposals")
    inf = os.path.join(chain.FT, "inference", "coco_instances_{}_results")
    verified_suffix = f"{chain.MINED}_{nn_model}_10_cosine"
    counts = {}
    for split in ("trainval", "unlabeled"):
        mined = load(inf.format(split) + chain.MINED + ".json")
        verified = load(inf.format(split) + verified_suffix + ".json")["annotations"]
        kept = {a["id"] for a in verified}
        if not kept or not kept <= {a["id"] for a in mined["annotations"]} or {
                a["category_id"] for a in verified} != {cls}:
            raise AssertionError(f"{split}: {len(kept)} verified candidates, not all mined ones of class {cls}")
        corrected = {a["id"]: a for a in load(inf.format(split) + verified_suffix + "_ubbr.json")}
        by_id = {a["id"]: a for a in load(inf.format(split) + verified_suffix + "_ubbr_id.json")["annotations"]}
        if set(corrected) != kept or set(by_id) != kept or any("bbox_orig" not in a for a in corrected.values()) \
                or any(np.abs(np.subtract(by_id[i]["bbox"], a["bbox"])).max() > 1e-4 for i, a in corrected.items()):
            raise AssertionError(f"{split}: corrected boxes do not follow the verified candidates by id")
        ignore = load(inf.format(split) + verified_suffix + "_ubbr_id_ignore.json")["annotations"]
        n_ignore = sum(bool(a.get("ignore_qe")) for a in ignore)
        if {a["id"] for a in ignore if not a.get("ignore_qe")} != kept or not n_ignore:
            raise AssertionError(f"{split}: _ignore.json keeps {len(ignore) - n_ignore} of {len(kept)}, "
                                 f"{n_ignore} ignores")
        counts[split] = (len(mined["annotations"]), len(kept), n_ignore)
    wbase = load(inf.format("trainval") + verified_suffix + "_ubbr_id_ignore_wbase.json")["annotations"]
    base_ig = load(inf.format("unlabeled") + verified_suffix + "_ubbr_id_ignore_wbase_base_ig.json")["annotations"]
    if not any("score" not in a for a in wbase) or len(base_ig) < counts["unlabeled"][1] + counts["unlabeled"][2]:
        raise AssertionError("combine_qe_with_base merged no base annotations")
    with open(os.path.join(work, chain.RETRAIN, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    if not rows or not math.isfinite(rows[-1]["total_loss"]):
        raise AssertionError(f"the retrain wrote no finite loss: {rows}")
    return counts


FT_ALL_YAML = "configs/COCO-detection/faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout.yaml"


def finetune_reference_check(tag):
    """One train step of faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout.yaml
    (80 classes, CosineSimOutputLayers) at the narrow widths of
    ``narrow_cfg``, float32, POOLER_IMPL pallas_train, DROPOUT 0 (masks
    differ between devices) and exhaustive sampling, on the card (K2 + K3)
    and on the CPU (plain versions) from the same weights, with the backbone
    frozen as the config has it and unfrozen as coco_full_run step 18 has
    it: every loss to rel 1e-4, every trainable gradient to rel L2 1e-4 (the
    tolerances of phase 6); K2/K3 launch 1/0 with the backbone frozen (its
    features take no gradient) and 1/1 without."""
    import torch

    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer

    # phase 6's batch, its 5 classes spread over the 80: its float32 gradients are within 4.3e-6 of float64 on
    # the CPU; with the same seed drawn over 80 classes the images differ, and float32 backbone gradients are
    # 2.1e-3 from float64 on the CPU alone (the input is ill-conditioned, on either device)
    batch = train_batch(2, 128, 192, 4, seed=3, device="cpu", num_classes=5, n_gt=(3, 3), size=(24, 100))
    batch["gt_classes"] = batch["gt_classes"] * 16
    for freeze in (True, False):
        cfg = get_cfg()
        cfg.merge_from_file(FT_ALL_YAML)
        cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
        cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
        cfg.MODEL.FPN.OUT_CHANNELS = 64
        cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
        cfg.MODEL.ROI_BOX_HEAD.DROPOUT = 0.0
        cfg.MODEL.ROI_HEADS.POOLER_IMPL = "pallas_train"
        cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
        cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
        cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192
        cfg.MODEL.RPN.POSITIVE_FRACTION = 0.999
        cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 128
        cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.999
        cfg.MODEL.BACKBONE.FREEZE = freeze
        cfg.SOLVER.WARMUP_ITERS = 0
        cpu = build_model(cfg, device="cpu")
        calibrated_init(cpu, seed=0)
        gpu = build_model(cfg)
        gpu.load_state_dict(cpu.state_dict())
        res = {}
        for key, model in (("cpu", cpu), ("gpu", gpu)):
            model.train()
            opt = build_optimizer(cfg, model)
            step = make_train_step(model, opt, build_lr_schedule(cfg, opt))
            ra.roi_align_paired.launches = ra.roi_align_paired_bwd.launches = 0
            metrics = step(batch, torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters() if p.requires_grad}
            res[key] = {k: float(v) for k, v in metrics.items()}, grads, (
                ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches)
        (c_loss, c_grad, c_n), (g_loss, g_grad, g_n) = res["cpu"], res["gpu"]
        want_n = (1, 0) if freeze else (1, 1)
        if c_n != (0, 0) or g_n != want_n:
            raise AssertionError(f"fine-tune step, backbone frozen {freeze}: K2/K3 launches {g_n}, want {want_n}")
        loss_err = max(abs(g_loss[k] - v) / max(abs(v), 1e-30) for k, v in c_loss.items())
        if set(c_loss) != set(g_loss) or loss_err > 1e-4 or c_loss["loss_box_reg"] <= 0:
            raise AssertionError(f"fine-tune losses differ: cpu {c_loss} card {g_loss}")
        if freeze == any(n.startswith("backbone.") for n in c_grad) or set(c_grad) != set(g_grad):
            raise AssertionError("fine-tune step: the trainable set does not follow BACKBONE.FREEZE")
        rel = {n: float((g_grad[n] - w).norm() / w.norm().clamp(min=1e-30)) for n, w in c_grad.items()}
        worst = max(rel, key=rel.get)
        if rel[worst] > 1e-4:
            raise AssertionError(f"fine-tune grads differ: {worst} rel L2 {rel[worst]}")
        print(f"fine-tune reference (cosine head, 80 classes, backbone frozen {freeze}): card vs CPU at float32, "
              f"losses { {k: round(v, 5) for k, v in c_loss.items()} } max rel err {loss_err:.2e} (tol 1e-4); "
              f"{len(rel)} trainable grads max rel L2 {rel[worst]:.2e} ({worst}; tol 1e-4); K2/K3 launches "
              f"{g_n[0]}/{g_n[1]} {tag}")


CHAIN_TREE = (32, 8, 8)  # training, test and unlabeled images
CHAIN_FT_NOVEL = "checkpoints/coco/faster_rcnn/faster_rcnn_R_50_FPN_ft_novel_30shot/model_final.pth"  # step 3's
CHAIN_ITERS = 6  # a training run of the chain: few, so that the whole script stays well inside its time limit
# K2/K3 launches of every iteration of the chain's training runs
CHAIN_LAUNCHES = {"1": (1, 1), "3": (1, 0), "5": (1, 0), "8": (3, 3), "9": (3, 0), "18": (1, 1)}


def lvc_chain_path(tag, weights: str, ubbr_weights: str, keep_novel: str):
    """The LVC chain of scripts/coco_full_run.sh at full width through its
    twin (``drive_chain``): all 18 steps on the configs as they stand
    (R-50-FPN, IMS_PER_BATCH 16, 832x1344, float32), each from the files of
    the steps before it, on a seeded tree (``write_chain_tree``: 32 training,
    8 test and 8 unlabeled JPEGs of 480x640 and 640x480, 80 classes, 30-shot
    files), from phase 17's checkpoint (steps 1 and 8) and phase 20's (step 8),
    with ``CHAIN_ITERS`` iterations a training run, gradient clipping at norm
    1 and a score threshold of 0 (a random cosine head can score every
    foreground class of every box below 0.001; the mining steps need rows),
    the verifier ViT-S/8 with seeded random weights. For each
    training run: ms/iter and img/s over the iterations after the first
    three, data_time, peak memory and the K2/K3 launches of every iteration
    (``CHAIN_LAUNCHES``); for the extraction steps, ms/img; the files'
    relations (``check_chain_files``); then K2 and K3 on one more step 18
    iteration's own tensors (16 x 512 slots, float32, C=256) against their
    plain versions. Kernel counts are set to 0 just before the chain and read
    just after. Step 3's 20-class ft_novel checkpoint is copied to
    ``keep_novel`` (phase 26 starts from it)."""
    import os
    import statistics
    import tempfile

    import torch

    from lvc_tpu_torch.engine.defaults import DefaultTrainer
    from lvc_tpu_torch.ops import roi_align as ra

    opts = ["SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
            "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0", "SEED", "0"]
    n_train, n_test, n_unlabeled = CHAIN_TREE
    current = {}
    real_step = DefaultTrainer.run_step
    k2, k3 = ra.roi_align_paired, ra.roi_align_paired_bwd  # the wrappers that count (PoolRecorder stands in)

    def run_step(self):
        n = k2.launches, k3.launches
        t0 = time.perf_counter()
        real_step(self)
        current["times"].append(time.perf_counter() - t0)
        current["launches"].append((k2.launches - n[0], k3.launches - n[1]))
        current["trainer"] = self

    def run(step, go):
        current.clear()
        current.update(times=[], launches=[])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        what = f"step {step.number} {step.tool}"
        if step.number in CHAIN_LAUNCHES:
            trainer, times, launches = current["trainer"], current["times"][3:], current["launches"]
            c = trainer.cfg
            if (c.SOLVER.IMS_PER_BATCH, c.MODEL.ROI_HEADS.POOLER_IMPL, c.SOLVER.AMP.ENABLED, c.SOLVER.MAX_ITER) != (
                    16, "auto", False, CHAIN_ITERS) or len(launches) != CHAIN_ITERS:
                raise AssertionError(f"{what}: not the config's batch 16, pool and float32, or not {CHAIN_ITERS} its")
            if set(launches) != {CHAIN_LAUNCHES[step.number]}:
                raise AssertionError(f"{what}: K2/K3 launches per iteration {sorted(set(launches))}, "
                                     f"want {CHAIN_LAUNCHES[step.number]}")
            data = trainer.storage.histories()["data_time"].values()
            print(f"coco_full_run {what}: {c.MODEL.ROI_HEADS.NAME}/{c.MODEL.ROI_HEADS.OUTPUT_LAYER}, "
                  f"{c.MODEL.ROI_HEADS.NUM_CLASSES} classes, backbone frozen {c.MODEL.BACKBONE.FREEZE}, mapper "
                  f"{type(trainer.data_loader.mapper).__name__}: {CHAIN_ITERS} iterations in {secs:.1f} s with its evaluation; the "
                  f"{len(times)} after the first 3 in {sum(times):.3f} s, {sum(times) / len(times) * 1e3:.2f} "
                  f"ms/iter, {16 * len(times) / sum(times):.2f} img/s; data_time median "
                  f"{statistics.median(data) * 1e3:.2f} ms (max {max(data) * 1e3:.2f}); peak memory {peak:.2f} GiB; "
                  f"K2/K3 launches {launches[0][0]}/{launches[0][1]} every iteration {tag}")
        else:
            images = {"6": n_test + n_train, "7": n_test + n_train, "10": n_train + n_unlabeled}.get(step.number)
            rate = f", {secs / images * 1e3:.2f} ms/img ({images} images, model build and load included)" \
                if images else ""
            print(f"coco_full_run {what}: {secs:.2f} s{rate} {tag}")

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        t0 = time.perf_counter()
        write_chain_tree(root, *CHAIN_TREE, sizes=((480, 640), (640, 480)), seed=0, max_boxes=8)
        work = os.path.join(tmp, "work")
        os.makedirs(work)
        print(f"coco_full_run: tree of {n_train} training, {n_test} test and {n_unlabeled} unlabeled images "
              f"written in {time.perf_counter() - t0:.1f} s {tag}")
        DefaultTrainer.run_step = run_step
        k2.launches = k3.launches = 0
        t0 = time.perf_counter()
        try:
            cls = drive_chain(root, work, CHAIN_ITERS, weights, ubbr_weights, opts, run)
        finally:
            DefaultTrainer.run_step = real_step
        secs = time.perf_counter() - t0
        n = k2.launches, k3.launches
        counts = check_chain_files(work, cls, "dino_vits8")
        shutil.copy(os.path.join(work, CHAIN_FT_NOVEL), keep_novel)
        print(f"coco_full_run: all 18 steps in {secs:.1f} s, each from the files of the steps before it; mined / "
              f"verified (class {cls}) / ignore regions: {counts}; K2/K3 launches over the chain {n[0]}/{n[1]} "
              f"{tag}")
        # the kernels on one more step 18 iteration's own tensors: 16 x 512 slots over the float32 C=256 pyramid
        with PoolRecorder() as rec:
            current["trainer"].run_step()
        if len(rec.fwd) != 1 or len(rec.bwd) != 1 or rec.fwd[0][1].rows.shape[0] != 16 * 512:
            raise AssertionError(f"recorded step 18 iteration: {len(rec.fwd)}/{len(rec.bwd)} pool calls")
        check_recorded_pool("coco_full_run step 18 iteration", rec, tag)


# ----------------------------------------------------------------- data parallel
DP_BATCH, DP_SEED = 4, 11  # phase 23's global batch and step seed
DP_CARD_GRAD_REL = 1e-5  # gradients and updates, rel L2, 2 ranks against 1 process on the card
DP_ITERS, DP_PERIOD = 20, 10  # phase 24's iterations and checkpoint period


def dp_cfg(kind: str, device: str, impl: str = "pallas_train"):
    """Phase 23's narrow models at float32 with sampling that is not
    exhaustive, so that the per-image generators decide the slots:
    ``detector`` is ``narrow_cfg`` (the RPN samples 256 of its 6,138
    anchors, the ROI heads 64 of up to 104 boxes, a quarter positive);
    ``cascade`` is ``corrector_cfg`` (RBG, 3 stages, each sampling 64 of
    its 128 jittered boxes); ``context`` is the detector as
    ``GeneralizedRCNN_Context`` (``cont_conv`` gets no gradient) and
    ``context_images_only`` that with ``MODEL.IMAGES_ONLY`` (the RPN, the
    ROI heads and the FPN levels below p5 get none); ``mask`` is the
    detector with ``MASK_ON`` (``narrow_task_heads``: a second pool, at
    P=14, and ``loss_mask``). ``impl`` pallas_train:
    K2 forward and K3 backward on the card, their plain versions on the
    CPU."""
    if kind in ("detector", "context", "context_images_only", "mask"):
        cfg = narrow_cfg(impl)
        cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
        cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
        cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
        if kind.startswith("context"):
            cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNN_Context"
            cfg.MODEL.IMAGES_ONLY = kind == "context_images_only"
        if kind == "mask":
            narrow_task_heads(cfg, mask=True)
    else:
        cfg = corrector_cfg(device)
        cfg.MODEL.ROI_HEADS.POOLER_IMPL = impl
    cfg.MODEL.DEVICE = device
    cfg.SOLVER.BASE_LR = 0.01
    return cfg


def dp_inputs(kind: str, cfg):
    """(weights, global batch) of phase 23 on the CPU: ``calibrated_init``
    weights (the corrector's stage regressors scaled as in
    ``corrector_inputs``) and a seeded batch of ``DP_BATCH`` 128x192 images
    with 2-5 valid gts each (and ``box_masks`` for ``mask``)."""
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model

    model = build_model(cfg.clone(), device="cpu")
    calibrated_init(model, seed=0)
    weights = model.state_dict()
    if kind == "cascade":
        with torch.no_grad():
            for name, t in weights.items():
                if ".bbox_pred.weight" in name:
                    t.mul_(0.02)
    batch = train_batch(DP_BATCH, 128, 192, 6, seed=5, device="cpu", num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
                        n_gt=(2, 5), size=(16, 90))
    if kind == "mask":
        batch["gt_masks"] = box_masks(batch["gt_boxes"], batch["gt_valid"], 128, 192)
    return weights, batch


class SlotRecorder:
    """While in use, records the slots of every ``subsample_labels`` call of
    the RPN and the ROI heads (cascade stages included), in call order: one
    call an image, the images of a batch in turn."""

    def __init__(self):
        from lvc_tpu_torch.modeling.proposal_generator import rpn
        from lvc_tpu_torch.modeling.roi_heads import roi_heads

        self.modules = {"rpn": rpn, "roi": roi_heads}
        self.calls = {"rpn": [], "roi": []}

    def _wrap(self, site, fn):
        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls[site].append(out[0][out[2]].cpu())  # the filled slots' indices
            return out
        return record

    def __enter__(self):
        self.saved = {k: m.subsample_labels for k, m in self.modules.items()}
        for k, m in self.modules.items():
            m.subsample_labels = self._wrap(k, self.saved[k])
        return self

    def __exit__(self, *exc):
        for k, m in self.modules.items():
            m.subsample_labels = self.saved[k]


def dp_step(cfg, weights, batch, seed: int, data_parallel: bool):
    """One train step of ``cfg``'s model from ``weights`` on ``batch`` (this
    process's share), through ``make_data_parallel_train_step`` or, without
    ``data_parallel``, ``make_train_step``: the metrics, every trainable
    gradient (after DDP's all-reduce), the parameters after the step, the
    sampled slots and the K2/K3 launches, all on the CPU."""
    import torch

    from lvc_tpu_torch.engine.train_loop import make_data_parallel_train_step, make_train_step
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer

    device = torch.device("cuda", torch.cuda.current_device()) if cfg.MODEL.DEVICE == "cuda" else torch.device("cpu")
    model = build_model(cfg, device=device)
    model.load_state_dict(weights)
    model.train()
    opt = build_optimizer(cfg, model)
    make = make_data_parallel_train_step if data_parallel else make_train_step
    step = make(model, opt, build_lr_schedule(cfg, opt))
    ra.roi_align_paired.launches = ra.roi_align_paired_bwd.launches = 0
    with SlotRecorder() as rec:
        metrics = step({k: v.to(device) for k, v in batch.items()}, seed)
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.requires_grad},
        "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
        "slots": rec.calls,
        "launches": (ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches),
        "batch": len(batch["image"]),
    }


def global_ratio_toy(device):
    """A toy loss through ``global_ratio`` under DDP in the default group:
    rank r holds rows ``r(r+1)/2 .. (r+1)(r+2)/2`` of a seeded X (r + 1
    rows), the loss is ``sum((X_r w)^2) / rows``, both sums over the ranks.
    Returns (loss, w's gradient after DDP, the analytic gradient
    ``2 X^T X w / N`` of all ranks' rows, N)."""
    import torch
    from torch.nn.parallel import DistributedDataParallel

    from lvc_tpu_torch.modeling.sampling import global_ratio, sampling_axis_scope
    from lvc_tpu_torch.utils import comm

    rank, world = comm.get_rank(), comm.get_world_size()
    n = world * (world + 1) // 2
    g = torch.Generator().manual_seed(0)
    X = torch.randn(n, 3, generator=g, dtype=torch.float64)
    lin = torch.nn.Linear(3, 1, bias=False).double()
    with torch.no_grad():
        lin.weight.copy_(torch.tensor([[0.5, -1.0, 2.0]], dtype=torch.float64))
    w = lin.weight.detach().clone()[0]
    lin = lin.to(device)
    ddp = DistributedDataParallel(lin)
    x = X[rank * (rank + 1) // 2:(rank + 1) * (rank + 2) // 2].to(device)
    with sampling_axis_scope():
        loss = global_ratio((ddp(x) ** 2).sum(), len(x))
    loss.backward()
    analytic = 2 * X.T @ (X @ w) / n
    return float(loss.detach()), lin.weight.grad.detach().cpu()[0], analytic, n


def dp_rank_main(out_dir: str, jobs):
    """One rank of a data-parallel check (phase 23, tests/test_torch_ddp.py):
    for each job ``(name, cfg, weights, global batch, seed)`` one
    ``dp_step`` on this rank's contiguous share of the batch, saved as
    ``<out_dir>/<name>_rank<r>.pt``; then ``global_ratio_toy``, saved as
    ``toy_rank<r>.pt``."""
    import os

    import torch

    from lvc_tpu_torch.utils import comm

    tf32_off()
    rank, world = comm.get_rank(), comm.get_world_size()
    for name, cfg, weights, batch, seed in jobs:
        n = len(batch["image"]) // world
        share = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
        torch.save(dp_step(cfg, weights, share, seed, data_parallel=True),
                   os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    device = "cuda" if jobs and jobs[0][1].MODEL.DEVICE == "cuda" else "cpu"
    torch.save(global_ratio_toy(device), os.path.join(out_dir, f"toy_rank{rank}.pt"))


def dp_load(out_dir: str, name: str, world: int):
    import os

    import torch

    return [torch.load(os.path.join(out_dir, f"{name}_rank{r}.pt"), weights_only=False) for r in range(world)]


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def dp_compare(ref, ranks, weights, loss_rel=2e-4, loss_abs=1e-5, grad_rel=1e-5, param_rel=1e-5):
    """Hold the ranks of one data-parallel step to the one-process step on
    the same global batch: every rank's losses within ``loss_rel`` /
    ``loss_abs``; every trainable gradient within rel L2 ``grad_rel``; the
    parameters after the step within ``param_rel`` of the update's L2 norm
    (the step's change from ``weights``) plus one float32 rounding of the
    parameter; every rank's parameters equal to rank 0's; each image's
    sampled slots (by its global position) equal. Returns the largest
    errors; raises on the first disagreement."""
    import torch

    world = len(ranks)
    loss_err = 0.0
    for r in ranks:
        if set(r["metrics"]) != set(ref["metrics"]):
            raise AssertionError(f"metrics {sorted(r['metrics'])} vs {sorted(ref['metrics'])}")
        for k, want in ref["metrics"].items():
            err = abs(r["metrics"][k] - want)
            if err > loss_abs + loss_rel * abs(want):
                raise AssertionError(f"{k}: {r['metrics'][k]} on a rank, {want} in one process")
            loss_err = max(loss_err, err / max(abs(want), 1e-30))
    grad_err = max(_rel_l2(ranks[0]["grads"][n], g) for n, g in ref["grads"].items())
    if set(ranks[0]["grads"]) != set(ref["grads"]) or grad_err > grad_rel:
        raise AssertionError(f"gradients differ: max rel L2 {grad_err:.2e} (tol {grad_rel})")
    param_err = 0.0
    for n, want in ref["params"].items():
        # the update's error, less one float32 rounding of the parameter (an update far below the
        # parameter's ulp is all rounding)
        got = ranks[0]["params"][n]
        err = float((got.double() - want.double()).norm())
        update = float((want.double() - weights[n].double()).norm())
        rounding = 2.0 ** -23 * float(want.double().norm())
        param_err = max(param_err, max(err - rounding, 0.0) / max(update, 1e-30))
        if err > param_rel * update + rounding:
            raise AssertionError(f"{n}: parameters after the step differ by {err:.3e} (update {update:.3e})")
        if any(not torch.equal(r["params"][n], got) for r in ranks):
            raise AssertionError(f"{n}: the ranks' parameters differ after the step")
    B = ranks[0]["batch"]
    for site, calls in ref["slots"].items():
        if len(calls) != len(ranks[0]["slots"][site]) * world:
            raise AssertionError(f"{site}: {len(calls)} sampling calls in one process")
        for r, rank in enumerate(ranks):
            for j, got in enumerate(rank["slots"][site]):
                inv, i = divmod(j, B)  # the call's stage and local image
                want = calls[inv * B * world + r * B + i]
                if not torch.equal(got, want):
                    raise AssertionError(f"{site} call {inv}: image {r * B + i} sampled other slots on rank {r}")
    return {"loss": loss_err, "grad": grad_err, "param": param_err,
            "slots": sum(len(c) for c in ref["slots"].values())}


def dp_toy_check(out_dir: str, world: int) -> str:
    """Every rank's toy loss equal and its gradient the analytic one (not
    ``world`` times too small or too large): within 1e-12 (float64)."""
    import torch

    toys = dp_load(out_dir, "toy", world)
    for loss, grad, analytic, n in toys:
        if abs(loss - toys[0][0]) > 1e-12 or float((grad - analytic).abs().max()) > 1e-12 * float(analytic.abs().max()):
            raise AssertionError(f"global_ratio toy: gradient {grad.tolist()} vs analytic {analytic.tolist()}")
    return f"global_ratio toy gradient = analytic over {toys[0][3]} rows on {world} ranks"


def dp_reference_check(tag):
    """Phase 23: one data-parallel step of each narrow model (``dp_cfg``) on
    the card from the same weights and the same global batch of
    ``DP_BATCH`` images, three ways: 2 ranks placed on cuda:0 with
    ``launch(..., devices=["cuda:0", "cuda:0"])`` (gloo: NCCL refuses two
    ranks on one device), 1 process without DDP, and 1 rank of NCCL DDP;
    with two cards or more, also 2 NCCL ranks on cuda:0 and cuda:1. Held by
    ``dp_compare`` (the ranks' losses, gradients, updated parameters and
    sampled slots) and the toy ``global_ratio`` gradient; K2/K3 1/1 a rank
    for the detector and the context detector, 3/3 for the cascade, 0/0
    for the context detector with ``IMAGES_ONLY``."""
    import os
    import tempfile

    import torch

    from lvc_tpu_torch.engine.launch import launch

    want_launches = {"detector": (1, 1), "cascade": (3, 3), "context": (1, 1), "context_images_only": (0, 0)}
    jobs, refs = [], {}
    for kind in want_launches:
        cfg = dp_cfg(kind, "cuda")
        weights, batch = dp_inputs(kind, cfg)
        jobs.append((kind, cfg, weights, batch, DP_SEED))
        refs[kind] = dp_step(cfg, weights, batch, DP_SEED, data_parallel=False)
    layouts = [("2 gloo ranks on cuda:0", ["cuda:0", "cuda:0"]), ("1 NCCL rank", ["cuda:0"])]
    if torch.cuda.device_count() >= 2:
        layouts.append(("2 NCCL ranks on cuda:0, cuda:1", ["cuda:0", "cuda:1"]))
    for what, devices in layouts:
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            launch(dp_rank_main, len(devices), args=(out, jobs), devices=devices)
            secs = time.perf_counter() - t0
            for kind, cfg, weights, _, _ in jobs:
                ranks = dp_load(out, kind, len(devices))
                got = [r["launches"] for r in ranks]
                if any(g != want_launches[kind] for g in got):
                    raise AssertionError(f"{kind} {what}: K2/K3 launches {got} a rank; want {want_launches[kind]}")
                # the card's one-process step at the same batch split is the reference; a rank's convolutions run
                # at a smaller batch, so the card may sum in another order than at B=4
                err = dp_compare(refs[kind], ranks, weights, grad_rel=DP_CARD_GRAD_REL, param_rel=DP_CARD_GRAD_REL)
                print(f"data parallel {kind} ({what}, launched in {secs:.1f} s): losses "
                      f"{ {k: round(v, 5) for k, v in refs[kind]['metrics'].items()} } max rel err {err['loss']:.2e} "
                      f"(tol 2e-4 / 1e-5), gradients max rel L2 {err['grad']:.2e}, updates {err['param']:.2e} (tol "
                      f"{DP_CARD_GRAD_REL}), ranks' parameters equal, {err['slots']} images' slots equal; K2/K3 "
                      f"{got[0][0]}/{got[0][1]} a rank {tag}")
            print(f"data parallel ({what}): {dp_toy_check(out, len(devices))} {tag}")



def dp_train_main(argv, report_dir: str, knn: bool):
    """One rank of phase 24: ``train_net.main`` on ``argv`` with the CLI's
    trainer recording its steps, then (``knn``) ``sharded_knn_vote`` at
    S=2,400, Q=50,000, D=384, k=10 against ``knn_vote`` on the same card.
    Writes ``<report_dir>/rank<r>.json``."""
    import json
    import os

    import torch

    from lvc_tpu_torch.ops.knn import knn_vote, sharded_knn_vote, similarity
    from lvc_tpu_torch.tools import train_net
    from lvc_tpu_torch.utils import comm

    tf32_off()
    torch.cuda.reset_peak_memory_stats()
    res, secs, (_, k2, k3), trainer = run_cli(train_net, argv)
    hist = trainer.storage.histories()
    report = {
        "rank": comm.get_rank(), "world": comm.get_world_size(), "secs": secs,
        "launches": [k2, k3],
        "step_s": trainer.step_s, "time": hist["time"].values(), "data_time": hist["data_time"].values(),
        "losses": {k: h.values() for k, h in hist.items() if k.startswith(("loss", "total"))},
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "results": res,
        "save_to_disk": trainer.checkpointer.save_to_disk,
        "writers": sum(type(h).__name__ == "PeriodicWriter" for h in trainer._hooks),
        "batch": trainer.data_loader.batch_size,
    }
    if knn:
        shots, classes, queries = clustered(4, 2400, 50000, 80, 384, "cuda")
        topk, mode = sharded_knn_vote(shots, classes, queries, k=10)
        want_topk, want_mode = knn_vote(shots, classes, queries, k=10)
        sim = similarity(shots, queries).topk(11, dim=-1).values
        clear = (sim[:, 9] - sim[:, 10]) > 1e-5  # no near-tie at the k-th neighbour
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            sharded_knn_vote(shots, classes, queries, k=10)
        torch.cuda.synchronize()
        sharded_ms = (time.perf_counter() - t1) * 1e3 / 5
        t1 = time.perf_counter()
        for _ in range(5):
            knn_vote(shots, classes, queries, k=10)
        torch.cuda.synchronize()
        report["knn"] = {
            "clear": int(clear.sum()), "queries": len(queries),
            "topk_equal": bool((topk == want_topk)[clear].all()), "mode_equal": bool((mode == want_mode)[clear].all()),
            "modes_equal_all": int((mode == want_mode).sum()), "ms": sharded_ms,
            "knn_vote_ms": (time.perf_counter() - t1) * 1e3 / 5,
        }
    with open(os.path.join(report_dir, f"rank{comm.get_rank()}.json"), "w") as f:
        json.dump(report, f, default=float)


def dp_train_net_path(tag, world: int = 2, devices=("cuda:0", "cuda:0")):
    """Phase 24: ``train_net.main`` through ``launch`` with 2 ranks placed on
    the one card (``devices=["cuda:0", "cuda:0"]``, gloo; ``devices=None``:
    the CLI's own placement, one card a rank, NCCL) on
    faster_rcnn_R_50_FPN_base.yaml as it stands (IMS_PER_BATCH 16: 8 a rank,
    832x1344, AMP) from phase 17's damped-init ``.pth``, ``DP_ITERS``
    iterations with a checkpoint every ``DP_PERIOD``, on phase 17's seeded
    tree, then the sharded final evaluation merged on rank 0. Checks:
    finite losses; the checkpoints, ``last_checkpoint`` and one
    ``metrics.json`` written by rank 0 alone; a 1-process ``--eval-only``
    run from the last checkpoint whose result rows and AP equal the merged
    evaluation's at phase 17's tolerance; K2/K3 1/1 a rank an iteration
    (plus K2 once per test image of the rank's shard). Then
    ``sharded_knn_vote`` over the ranks."""
    import json
    import math
    import os
    import statistics
    import tempfile

    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.engine.launch import launch
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.tools import train_net
    from lvc_tpu_torch.utils.init import damped_init

    n_train, n_test = TRAIN_NET_TREE
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        write_coco_tree(root, n_train, n_test, sizes=((480, 640), (640, 480)), seed=0, max_boxes=8)
        use_coco_tree(root)
        cfg = get_cfg()
        cfg.merge_from_file(TRAIN_NET_YAML)
        model = damped_init(build_model(cfg), seed=0)
        weights = DetectionCheckpointer(model, os.path.join(tmp, "weights")).save("damped_init", iteration=0)
        del model
        torch.cuda.empty_cache()
        out, reports = os.path.join(tmp, "out"), os.path.join(tmp, "reports")
        os.makedirs(reports)
        opts = ["MODEL.WEIGHTS", weights, "SOLVER.AMP.ENABLED", "True", "SOLVER.BASE_LR", "1e-4",
                "SOLVER.CHECKPOINT_PERIOD", str(DP_PERIOD), "SEED", "0",
                "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.001"]
        yaml = ["--config-file", TRAIN_NET_YAML]
        argv = yaml + ["--num-gpus", str(world)] + opts + ["OUTPUT_DIR", out, "SOLVER.MAX_ITER", str(DP_ITERS)]
        t0 = time.perf_counter()
        launch(dp_train_main, world, args=(argv, reports, True), devices=None if devices is None else list(devices))
        secs = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(reports, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        shared = devices is not None and len(set(devices)) < len(devices)
        for r in ranks:
            want = (DP_ITERS + n_test // len(ranks), DP_ITERS)
            if tuple(r["launches"]) != want or r["batch"] != 16 // len(ranks):
                raise AssertionError(f"rank {r['rank']}: K2/K3 {r['launches']} (want {want}), batch {r['batch']}")
            if not all(math.isfinite(v) for vals in r["losses"].values() for v in vals) or len(r["losses"]) < 5:
                raise AssertionError(f"rank {r['rank']}: non-finite or missing losses {r['losses']}")
        if [(r["save_to_disk"], r["writers"]) for r in ranks] != [(True, 1)] + [(False, 0)] * (len(ranks) - 1):
            raise AssertionError("only rank 0 may write checkpoints and metrics")
        with open(os.path.join(out, "metrics.json")) as f:
            rows = [json.loads(line) for line in f]
        iters = [row["iteration"] for row in rows]
        # one writer: a row every 20 steps and one after training (two writers would double them)
        if iters != [DP_ITERS - 1] * 2 or not all(
                math.isfinite(v) for row in rows for k, v in row.items() if k.startswith(("loss", "total"))):
            raise AssertionError(f"metrics.json: {len(rows)} rows at iterations {iters}")
        saved = [f"model_{DP_PERIOD - 1:07d}.pth", f"model_{DP_ITERS - 1:07d}.pth"]
        for name in saved + ["last_checkpoint"]:
            if not os.path.exists(os.path.join(out, name)):
                raise AssertionError(f"{name} was not written")
        with open(os.path.join(out, "inference", "res_final.json")) as f:
            final = json.load(f)
        merged = result_rows(os.path.join(out, "inference", "coco_instances_test_results.json"))
        if ranks[0]["results"] != final or any(r["results"] for r in ranks[1:]):
            raise AssertionError("the merged evaluation must come back on rank 0 alone")

        # the 1-process --eval-only run from the last checkpoint, in this process
        eval_out = os.path.join(tmp, "eval")
        eval_opts = list(opts)
        eval_opts[1] = os.path.join(out, saved[1])
        res, _, (_, k2, k3), _ = run_cli(train_net, yaml + ["--eval-only"] + eval_opts + ["OUTPUT_DIR", eval_out])
        got = result_rows(os.path.join(eval_out, "inference", "coco_instances_test_results.json"))
        if len(got) != len(merged) or len(merged) < 100:
            raise AssertionError(f"--eval-only: {len(got)} result rows; the merged evaluation wrote {len(merged)}")
        box_err = score_err = 0.0
        for w, g in zip(merged, got):
            if (w["image_id"], w["category_id"]) != (g["image_id"], g["category_id"]):
                raise AssertionError(f"--eval-only result rows differ: {g} vs {w}")
            box_err = max(box_err, max(abs(a - b) for a, b in zip(w["bbox"], g["bbox"])))
            score_err = max(score_err, abs(w["score"] - g["score"]))
        ap_err = max(abs(res["bbox"][k] - v) for k, v in final["bbox"].items())
        if (k2, k3) != (n_test, 0) or box_err > 1e-3 or score_err > 1e-6 or ap_err > 1e-9:
            raise AssertionError(f"--eval-only: K2/K3 {k2}/{k3}, box err {box_err} px, score err {score_err}, "
                                 f"results {res['bbox']} vs {final['bbox']}")
    steps = [s for r in ranks for s in r["step_s"][3:]]
    where = (f"{len(ranks)} ranks placed on the one card (gloo through the host; the ranks share one card here, so "
             f"this is no scaling number)" if shared else f"{len(ranks)} NCCL ranks, one a card")
    print(f"data parallel train_net: {where}, R-50-FPN base AMP, IMS_PER_BATCH 16 ({16 // len(ranks)} a rank) at "
          f"832x1344, "
          f"{DP_ITERS} iterations in {secs:.1f} s (spawn and build included): "
          + "; ".join(f"rank {r['rank']} {statistics.mean(r['step_s'][3:]) * 1e3:.2f} ms/iter over the "
                      f"{len(r['step_s'][3:])} steps after warm-up (`time` median "
                      f"{statistics.median(r['time']) * 1e3:.2f} ms), data_time median "
                      f"{statistics.median(r['data_time']) * 1e3:.2f} ms, peak memory {r['peak_gib']:.2f} GiB, K2/K3 "
                      f"{r['launches'][0]}/{r['launches'][1]}" for r in ranks)
          + f" (mean of all {statistics.mean(steps) * 1e3:.2f} ms/iter) {tag}")
    print(f"data parallel train_net: final total_loss {rows[-1]['total_loss']:.4f}; rank 0 alone wrote "
          f"{', '.join(saved)}, last_checkpoint and metrics.json ({len(rows)} rows); merged evaluation "
          f"{len(merged)} rows, bbox AP {final['bbox']['AP']:.4f}, equal to the 1-process --eval-only from "
          f"{saved[1]} (box err {box_err:.1e} px, tol 1e-3; score err {score_err:.1e}, tol 1e-6; AP diff "
          f"{ap_err:.1e}, tol 1e-9; K2 {k2}) {tag}")
    knn = ranks[0]["knn"]
    if not (knn["topk_equal"] and knn["mode_equal"]) or knn["clear"] < 0.99 * knn["queries"]:
        raise AssertionError(f"sharded_knn_vote differs from knn_vote away from near-ties: {knn}")
    print(f"sharded_knn_vote S=2400 Q=50000 D=384 k=10 over {where}: top-k and modes equal to "
          f"knn_vote on {knn['clear']} of {knn['queries']} queries away from near-ties (gap > 1e-5; modes equal on "
          f"{knn['modes_equal_all']} of all), {knn['ms']:.3f} ms a call on rank 0 (the gather included; knn_vote "
          f"alone on all the queries {knn['knn_vote_ms']:.3f} ms in the same rank) {tag}")


# ---------------------------------------------------------------------------
# The extra ROI heads: ParallelStandardROIHeads, CascadeStandardROIHeads,
# StandardROIHeadsCascadeBBox, the C4 Res5ROIHeads and the debug inference
# ---------------------------------------------------------------------------

# (K2/K3 launches of a training step, K1/K2 launches of an eval forward) of the narrow models of phase 25
EXTRA_LAUNCHES = {
    "ParallelStandardROIHeads": ((2, 2), (0, 2)), "CascadeStandardROIHeads": ((1, 1), (0, 2)),
    "StandardROIHeadsCascadeBBox": ((1, 1), (0, 1)), "Res5ROIHeads": ((1, 1), (0, 1)),
    "StandardROIHeads": (None, (0, 1)), "Res5ROIHeads pallas_fast": (None, (1, 0)),
}


def c4_cfg():
    """``lvc_tpu/config/defaults.py``'s own C4 detector (detectron2's
    Base-RCNN-C4: res4 features, ``Res5ROIHeads``, a 14 x 14 pool, RPN
    6000/1000 at test) with the plain ResNet backbone, built in code."""
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.BACKBONE.NAME = "build_resnet_backbone"
    return cfg


def extra_heads_cfg(name: str, device: str):
    """Phase 25's narrow models at float32 with exhaustive sampling and
    POOLER_IMPL pallas_train (K2 and K3 on the card, their plain versions on
    the CPU): phase 6's R-50-FPN with ``name``'s ROI heads (80 classes for
    ``ParallelStandardROIHeads``; ``StandardROIHeads`` with ``DEBUG``), or
    ``c4_cfg`` at the same widths (res4 256 wide) for ``Res5ROIHeads``."""
    if name == "Res5ROIHeads":
        cfg = c4_cfg()
        cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
        cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
        cfg.MODEL.ROI_HEADS.POOLER_IMPL = "pallas_train"
    else:
        cfg = narrow_cfg("pallas_train")
        cfg.MODEL.ROI_HEADS.NAME = name
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80 if name == "ParallelStandardROIHeads" else 5
    cfg.DEBUG = name == "StandardROIHeads"
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192
    cfg.MODEL.RPN.POSITIVE_FRACTION = 0.999
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 128
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.999
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
    cfg.TEST.DETECTIONS_PER_IMAGE = 30
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.MODEL.DEVICE = device
    return cfg


def extra_heads_init(model, seed: int = 0):
    """``calibrated_init``, plus its scaling where the names differ: the C4
    backbone's convs (no ``bottom_up``) and the twin heads' predictors."""
    import torch

    calibrated_init(model, seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.startswith(("backbone.stem.", "backbone.res")) and t.dim() == 4:
                t.mul_(0.8)
            elif name.startswith("roi_heads.roi_heads.") and ".box_predictor.cls_score.weight" in name:
                t.mul_(0.03)
            elif name.startswith("roi_heads.roi_heads.") and ".box_predictor.bbox_pred.weight" in name:
                t.mul_(0.3)
    return model


def float64_witness():
    """A function mode under which a model converted to float64 on the CPU
    (``.double()``, ``compute_dtype`` float64) runs the float32 model's code
    in float64: a cast of a float64 tensor to float32 (``.float()``,
    ``.to(torch.float32)``) keeps it float64. Anchors, gt boxes and
    sampling draws stay float32, so the witness matches and samples as the
    float32 runs do."""
    import torch
    from torch.overrides import TorchFunctionMode

    class KeepFloat64(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in (torch.Tensor.float, torch.Tensor.to) and isinstance(args[0], torch.Tensor) \
                    and args[0].dtype == torch.float64:
                if func is torch.Tensor.float:
                    return args[0]
                args = tuple(torch.float64 if a is torch.float32 else a for a in args)
                kwargs = {k: torch.float64 if v is torch.float32 else v for k, v in kwargs.items()}
            return func(*args, **kwargs)

    return KeepFloat64()


def detection_errors(what, c, g):
    """Two runs' detections (any ``Detections`` type), ``g`` against the
    reference ``c``: validity, classes, proposal slots and the debug top-2
    classes must be equal. Returns the number of valid slots and the
    largest box (px) and score (with the debug top-2 scores) errors."""
    import torch

    v = c.valid
    if not torch.equal(v, g.valid) or int(v.sum()) < 10 or not torch.equal(c.classes[v], g.classes[v]) \
            or not torch.equal(c.proposal_idx[v], g.proposal_idx[v]):
        raise AssertionError(f"{what}: detections differ in validity, class or proposal")
    box_err = float((c.boxes[v].double() - g.boxes[v].double()).abs().max())
    score_err = float((c.scores[v].double() - g.scores[v].double()).abs().max())
    if hasattr(c, "top2_inds"):
        if not torch.equal(c.top2_inds[v], g.top2_inds[v]):
            raise AssertionError(f"{what}: debug top-2 classes differ")
        score_err = max(score_err, float((c.top2_scores[v].double() - g.top2_scores[v].double()).abs().max()))
    return int(v.sum()), box_err, score_err


# Phase 25 holds the card's float32 and the CPU's float32 against a float64
# witness on the CPU. The card's distance may be WITNESS_FACTOR times the
# CPU's, or the FLOOR of the quantity, whichever is larger: 10 where both
# devices run the same kind of sums (losses, detections), 100 for the
# gradients, whose convolution weight reductions cuDNN runs by other
# algorithms than the CPU (tiled, split or transformed sums round more than
# a direct one). A fault moves a result by far more.
WITNESS_FACTOR = {"loss": 10, "grad": 100, "box": 10, "score": 10}
WITNESS_FLOOR = {"loss": 1e-4, "grad": 1e-4, "box": 1e-3, "score": 1e-4}


def witness_limit(kind, cpu_err):
    return max(WITNESS_FLOOR[kind], WITNESS_FACTOR[kind] * cpu_err)


def extra_heads_run(model, cfg, batch, train, recorder=None, optimizer=None):
    """One run of a phase 25 model: (losses, trainable gradients as float64,
    eval detections on the CPU, (K2, K3) launches of the step, K1 and K2
    launches of the eval forward). ``train``: a training step (generator
    seed 0) first; the eval forward runs from the weights before it.
    ``recorder`` records the step, or the eval forward where there is no
    step. ``optimizer``: the function that builds the step's optimizer (default
    ``build_optimizer``). A model in float64 runs under ``float64_witness``
    on the batch's image in float64."""
    import contextlib

    import torch

    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer

    witness = next(model.parameters()).dtype == torch.float64
    mode = float64_witness() if witness else contextlib.nullcontext()
    if witness:
        batch = dict(batch, image=torch.as_tensor(batch["image"]).double())
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    losses = grads = step_n = None
    with mode:
        if train:
            model.train()
            opt = (optimizer or build_optimizer)(cfg, model)
            step = make_train_step(model, opt, build_lr_schedule(cfg, opt))
            ra.roi_align_paired.launches = ra.roi_align_paired_bwd.launches = 0
            with recorder or contextlib.nullcontext():
                metrics = step(batch, torch.Generator().manual_seed(0))
            step_n = ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches
            losses = {k: float(v) for k, v in metrics.items()}
            grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters() if p.requires_grad}
            model.load_state_dict(weights)
        model.eval()
        ra.roi_align_band.launches = ra.roi_align_paired.launches = 0
        with (recorder if not train else None) or contextlib.nullcontext():
            dets = model(batch)
        eval_n = ra.roi_align_band.launches, ra.roi_align_paired.launches
    return losses, grads, to_cpu(dets), step_n, eval_n


def to_cpu(out):
    """A model output (a tensor, a dict of outputs or ``Detections``, whose
    ``None`` fields stay ``None``) copied to the CPU."""
    if out is None or hasattr(out, "cpu"):
        return None if out is None else out.cpu()
    if isinstance(out, dict):
        return {k: to_cpu(v) for k, v in out.items()}
    return type(out)(*[to_cpu(t) for t in out])


def extra_heads_reference_check(tag):
    """Phase 25: each extra ROI head (``extra_heads_cfg``) at float32 on the
    card and on the CPU, both held against a float64 witness of the same
    weights (``extra_heads_init``) on the CPU (``float64_witness``), each
    within ``witness_limit`` of the CPU's own distance: one training step
    (exhaustive sampling, so every run samples the same sets) with its
    losses and trainable gradients, then the eval forward's detections
    (``detection_errors``). The C4 model runs on three batches, as its
    float32 backbone gradients are the least well conditioned, and also
    serves with POOLER_IMPL pallas_fast (K1's band form on one level).
    CascadeStandard's inference pools twice, Parallel's twins pool once
    each; the launch counts of each card run are ``EXTRA_LAUNCHES``. K1, K2
    and K3 are then held to their plain versions on the last C4 batch's own
    P=14 single-level tensors (``check_recorded_pool``)."""
    import copy

    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model

    small = train_batch(2, 128, 192, 4, seed=3, device="cpu", num_classes=5, n_gt=(3, 3), size=(24, 100))
    large = train_batch(2, 256, 320, 4, seed=3, device="cpu", num_classes=5, n_gt=(3, 3), size=(24, 120))
    large["gt_boxes"][:, 0] = torch.tensor([[20.0, 10.0, 260.0, 240.0], [40.0, 5.0, 300.0, 250.0]])  # > 200^2
    parallel = dict(small, gt_classes=small["gt_classes"] * 16)  # seen and unseen ids of the 80
    c4 = {f"seed {seed}, gt {lo}-{hi} px": train_batch(2, 128, 192, 4, seed=seed, device="cpu", num_classes=5,
                                                       n_gt=(3, 3), size=(lo, hi))
          for seed, lo, hi in ((3, 24, 100), (3, 40, 120), (8, 40, 120))}
    last_c4 = list(c4)[-1]
    runs = [("ParallelStandardROIHeads", "", parallel), ("CascadeStandardROIHeads", "", small),
            ("StandardROIHeadsCascadeBBox", "", large)]
    runs += [("Res5ROIHeads", label, batch) for label, batch in c4.items()] + [("StandardROIHeads", "", small)]
    runs.append(("Res5ROIHeads pallas_fast", "", c4[last_c4]))
    c4_rec = PoolRecorder()
    lines = []
    for name, label, batch in runs:
        head = name.split()[0]
        cfg = extra_heads_cfg(head, "cpu")
        if name.endswith("pallas_fast"):
            cfg.MODEL.ROI_HEADS.POOLER_IMPL = "pallas_fast"
        cpu = extra_heads_init(build_model(cfg, device="cpu"))
        witness = copy.deepcopy(cpu).double()
        witness.compute_dtype = torch.float64
        gpu_cfg = cfg.clone()
        gpu_cfg.MODEL.DEVICE = "cuda"
        gpu = build_model(gpu_cfg)
        gpu.load_state_dict(cpu.state_dict())
        want_train, want_eval = EXTRA_LAUNCHES[name]
        # recorded on the card: the C4 step on the last batch and the pallas_fast forward
        recorder = c4_rec if name.endswith("pallas_fast") or label == last_c4 else None
        res = {key: extra_heads_run(model, cfg, batch, want_train is not None, recorder if key == "gpu" else None)
               for key, model in (("cpu", cpu), ("f64", witness), ("gpu", gpu))}
        if head == "Res5ROIHeads" and want_train is not None:
            # what part of the card's distance cuDNN's algorithms make: PyTorch's own CUDA convolutions,
            # whose NCHW outputs go back to channels_last for the pool
            hook = gpu.backbone.register_forward_hook(
                lambda module, args, out: {k: v.contiguous(memory_format=torch.channels_last) for k, v in out.items()})
            try:
                with torch.backends.cudnn.flags(enabled=False):
                    _, n_grad, *_ = extra_heads_run(gpu, cfg, batch, True)
            finally:
                hook.remove()
        (c_loss, c_grad, c_dets, _, _), (w_loss, w_grad, w_dets, _, _), (g_loss, g_grad, g_dets, g_step, g_eval) = (
            res["cpu"], res["f64"], res["gpu"])
        if (g_step, g_eval) != (want_train, want_eval):
            raise AssertionError(f"{name}: card launches (K2/K3 a step, K1/K2 an eval) {(g_step, g_eval)}, "
                                 f"want {(want_train, want_eval)}")
        what = f"{name}{' (DEBUG)' if cfg.DEBUG else ''}{f' [{label}]' if label else ''}"
        part = ""
        if want_train is not None:
            if not (set(c_loss) == set(g_loss) == set(w_loss)) or min(w_loss.values()) <= 0 \
                    or not (set(c_grad) == set(g_grad) == set(w_grad)):
                raise AssertionError(f"{what}: loss or gradient names differ, or a loss is not positive")
            errs = {}
            for kind, want, c, g in (("loss", w_loss, c_loss, g_loss), ("grad", w_grad, c_grad, g_grad)):
                if kind == "loss":
                    rel = lambda a, w: abs(a - w) / abs(w)  # noqa: E731
                else:
                    rel = lambda a, w: float((a - w).norm() / w.norm().clamp(min=1e-30))  # noqa: E731
                c_err = {k: rel(c[k], w) for k, w in want.items()}
                g_err = {k: rel(g[k], w) for k, w in want.items()}
                over = [k for k in want if g_err[k] > witness_limit(kind, c_err[k])]
                if over:
                    k = over[0]
                    raise AssertionError(f"{what}: card {kind} {k} {g_err[k]:.3e} from float64, the CPU's "
                                         f"{c_err[k]:.3e} (limit {witness_limit(kind, c_err[k]):.3e})")
                worst = max(g_err, key=g_err.get)
                errs[kind] = (f"{len(want)} {kind}{'es' if kind == 'loss' else 's'} from float64: card max "
                              f"{g_err[worst]:.3e} ({worst}; the CPU's {c_err[worst]:.3e} there, limit "
                              f"{witness_limit(kind, c_err[worst]):.3e}), CPU max {max(c_err.values()):.3e}, "
                              f"largest card/CPU ratio {max(g_err[k] / max(c_err[k], 1e-30) for k in want):.1f}")
            part = f"{errs['loss']}; {errs['grad']}; K2/K3 a step {g_step[0]}/{g_step[1]}; "
            if head == "Res5ROIHeads":
                n_err = {k: float((n_grad[k] - w).norm() / w.norm().clamp(min=1e-30)) for k, w in w_grad.items()}
                worst = max(n_err, key=n_err.get)
                part += f"with cuDNN off the card's grads max {n_err[worst]:.3e} from float64 ({worst}); "
        n, c_box, c_score = detection_errors(f"{what} CPU vs float64", w_dets, c_dets)
        _, g_box, g_score = detection_errors(f"{what} card vs float64", w_dets, g_dets)
        if g_box > witness_limit("box", c_box) or g_score > witness_limit("score", c_score):
            raise AssertionError(f"{what}: card boxes {g_box:.3e} px and scores {g_score:.3e} from float64, the "
                                 f"CPU's {c_box:.3e} and {c_score:.3e}")
        lines.append(f"{what}: {part}eval {type(g_dets).__name__} {tuple(g_dets.boxes.shape)}, {n} valid, boxes from "
                     f"float64 card {g_box:.3e} px CPU {c_box:.3e} (limit {witness_limit('box', c_box):.3e}), scores "
                     f"card {g_score:.3e} CPU {c_score:.3e} (limit {witness_limit('score', c_score):.3e}), K1/K2 "
                     f"{g_eval[0]}/{g_eval[1]}")
    for line in lines:
        print(f"extra heads reference (card and CPU float32 against CPU float64, narrow): {line} {tag}")
    if len(c4_rec.band) != 1 or len(c4_rec.fwd) != 1 or len(c4_rec.bwd) != 1 \
            or c4_rec.fwd[0][1].rows.shape[1] != 14 or len(c4_rec.fwd[0][0]) != 1:
        raise AssertionError("the C4 runs did not record one single-level P=14 call of each kernel")
    check_recorded_pool("extra heads reference C4 (P=14, res4)", c4_rec, tag)


PARALLEL_ITERS = 20


def parallel_finetune_path(tag, base_pth: str, novel_pth: str):
    """Phase 26, the twin-head fine-tune at full width:
    ``ckpt_surgery --method combine_parallel --coco`` of ``base_pth`` (phase
    17's 60-class checkpoint) and ``novel_pth`` (the chain's 20-class
    ft_novel checkpoint, phase 22), loaded strictly into the built
    ``ParallelStandardROIHeads`` model; ``train_net`` on
    faster_rcnn_R_50_FPN_base.yaml with ``MODEL.ROI_HEADS.NAME
    ParallelStandardROIHeads``, 80 classes, the all-class splits of phase
    17's seeded tree, IMS_PER_BATCH 16 at 832x1344, AMP, ``PARALLEL_ITERS``
    iterations, then its evaluation (K2 twice an image); K2/K3 2/2 every
    iteration; 2 x DETECTIONS_PER_IMAGE = 200 slots with classes in the
    80-way space."""
    import json
    import math
    import os
    import tempfile

    import torch

    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.tools import ckpt_surgery, train_net

    n_train, n_test = TRAIN_NET_TREE
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        write_coco_tree(root, n_train, n_test, sizes=((480, 640), (640, 480)), seed=0, max_boxes=8)
        use_coco_tree(root)
        combined = ckpt_surgery.main(ckpt_surgery.parser.parse_args([
            "--method", "combine_parallel", "--coco", "--src1", base_pth, "--src2", novel_pth, "--save-dir", tmp]))
        opts = ["MODEL.ROI_HEADS.NAME", "ParallelStandardROIHeads", "MODEL.ROI_HEADS.NUM_CLASSES", "80",
                "DATASETS.TRAIN", "('coco_trainval_all',)", "DATASETS.FS_TRAIN", "('coco_trainval_all',)",
                "DATASETS.TEST", "('coco_test_all',)", "MODEL.WEIGHTS", combined, "SOLVER.BASE_LR", "1e-4", "SOLVER.CHECKPOINT_PERIOD", "1000000",
                "SEED", "0", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.001"]
        cfg = get_cfg()
        cfg.merge_from_file(TRAIN_NET_YAML)
        cfg.merge_from_list(opts)
        model = build_model(cfg)
        missing, unexpected = model.load_state_dict(torch.load(combined, weights_only=False)["model"], strict=True)
        twins = sum(1 for k in model.state_dict() if k.startswith("roi_heads.roi_heads."))
        del model
        torch.cuda.empty_cache()
        out = os.path.join(tmp, "out")
        yaml = ["--config-file", TRAIN_NET_YAML]
        torch.cuda.reset_peak_memory_stats()
        res, secs, n, trainer = run_cli(
            train_net, yaml + opts + ["SOLVER.AMP.ENABLED", "True", "SOLVER.MAX_ITER", str(PARALLEL_ITERS), "OUTPUT_DIR", out])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        c = trainer.cfg
        if (c.SOLVER.IMS_PER_BATCH, c.MODEL.ROI_HEADS.POOLER_IMPL) != (16, "auto") or not c.SOLVER.AMP.ENABLED:
            raise AssertionError("the phase must run the config's IMS_PER_BATCH 16, POOLER_IMPL auto and AMP")
        if set(trainer.step_launches) != {(2, 2)} or n[1:] != (2 * PARALLEL_ITERS + 2 * n_test, 2 * PARALLEL_ITERS):
            raise AssertionError(f"K2/K3 per iteration {sorted(set(trainer.step_launches))}, in all {n[1:]}")
        with open(os.path.join(out, "metrics.json")) as f:
            rows = [json.loads(line) for line in f]
        keys = {k for r in rows for k in r if k.startswith(("base_", "novel_"))}
        if keys != {f"{p}_loss_{k}" for p in ("base", "novel") for k in ("cls", "box_reg")} or not all(
                math.isfinite(v) for r in rows for k, v in r.items() if k.startswith(("loss", "total", "base", "novel"))):
            raise AssertionError(f"metrics.json: twin losses {sorted(keys)}, or not finite")
        ap = res["bbox"]["AP"]
        result = result_rows(os.path.join(out, "inference", "coco_instances_test_results.json"))
        if not math.isfinite(ap) or ap < 0 or not result:
            raise AssertionError(f"no finite bbox AP or no result rows: {res}, {len(result)} rows")
        model = trainer.model
        model.eval()
        g = torch.Generator(device="cuda").manual_seed(0)
        probe = {"image": torch.rand(1, 832, 1344, 3, generator=g, device="cuda") * 255,
                 "image_size": torch.tensor([[832, 1344]], dtype=torch.int32, device="cuda")}
        dets = model(probe)
        D = 2 * c.TEST.DETECTIONS_PER_IMAGE
        if tuple(dets.boxes.shape) != (1, D, 4) or not dets.valid.any() or bool((dets.classes[dets.valid] >= 80).any()):
            raise AssertionError(f"merged detections {tuple(dets.boxes.shape)}, {int(dets.valid.sum())} valid, "
                                 f"want (1, {D}, 4) in 80 classes")
        print(f"parallel fine-tune: combine_parallel of phase 17's base (60 classes) and the chain's ft_novel (20) "
              f"loaded strictly (missing {len(missing)}, unexpected {len(unexpected)}, {twins} twin tensors); "
              f"train_net ParallelStandardROIHeads, 80 classes, AMP, IMS_PER_BATCH 16 at 832x1344, bbox AP {ap:.4f} "
              f"of {len(result)} result rows on {n_test} images ({len(rows)} metrics rows), merged detections "
              f"{tuple(dets.boxes.shape)} with {int(dets.valid.sum())} valid {tag}")
        train_net_report("parallel fine-tune train_net", trainer, secs, peak, 16, tag)


C4_ITERS = 20


def wide_box_distance(level, proposals):
    """How far K2 (``pallas``) and K1's band form (``pallas_fast``) are from
    the exact point gather on one stride-16 level at P=14: the largest
    absolute difference over boxes whose sample columns span more than the
    paired window's 46 (JAX's semantics collapse their far samples onto the
    window's last column) and over the others, each over the largest
    |exact| value."""
    import torch

    from lvc_tpu_torch.ops import roi_align as ra

    B, H, W = level.shape[0], level.shape[1] * 16, level.shape[2] * 16
    wide = torch.tensor([[0, 0, W, H], [0, H / 2 - 80, W, H / 2 + 80], [40, 0, W - 40, 120], [0, H - 100, W, H],
                         [100, 200, 900, 500], [300, 0, 1200, H], [0, 0, 800, H], [W - 820, 10, W, 300]],
                        dtype=torch.float32, device=level.device)
    boxes = torch.cat([proposals.float(), wide[None].expand(B, -1, -1)], 1)
    kw = dict(output_size=14, sampling_ratio=0, max_grid=2, min_level=4)
    exact = ra.batched_multilevel_roi_align([level], boxes, (16,), **kw)
    span = (boxes[..., 2] - boxes[..., 0]) / 16 > 45
    scale = float(exact.abs().max())
    parts = [f"{int(span.sum())} wide and {int((~span).sum())} other boxes"]
    for name, got in (("K2", ra.pool_paired([level], boxes, (16,), **kw)),
                      ("K1 band", ra.pool_band([level], boxes, (16,), **kw))):
        err = (got - exact).abs().amax(dim=(2, 3, 4)) / scale
        parts.append(f"{name} max |diff| / max |exact| {float(err[span].max()):.3e} on the wide, "
                     f"{float(err[~span].max()):.3e} on the others")
    return "; ".join(parts)


def c4_path(tag):
    """Phase 27, R-50-C4 at full width (``c4_cfg``: res4 1024 wide, P=14,
    80 classes), 2 images a card at 832x1344 (Base-RCNN-C4's IMS_PER_BATCH 16
    over 8 cards), seeded damped weights: a bf16 serving forward with
    POOLER_IMPL pallas_fast (K1's band form: one level) and one with auto
    (K2), 1 warm-up and 3 timed each, every kernel count set to 0 just
    before and read just after; the score threshold is 0.001, so that the
    random detector's candidates reach the per-class NMS and every timed
    forward keeps detections; ``train_net`` with POOLER_IMPL pallas_train
    and AMP for ``C4_ITERS`` iterations on phase 17's seeded tree (K2/K3
    1/1 every iteration), then its evaluation; K1, K2 and K3 on the path's
    own tensors (one forward of each pool, one more training iteration)
    against their plain versions, with their times and bounds."""
    import os
    import tempfile

    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.tools import train_net
    from lvc_tpu_torch.utils.init import damped_init

    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, W = 2, 832, 1344
    batch = {"image": torch.rand(B, H, W, 3, generator=g, device="cuda") * 255,
             "image_size": torch.tensor([[H, W]] * B, dtype=torch.int32, device="cuda")}
    rec = PoolRecorder()
    serving = []
    for impl, kernel in (("pallas_fast", ra.roi_align_band), ("auto", ra.roi_align_paired)):
        cfg = c4_cfg()
        cfg.MODEL.DTYPE = "bfloat16"
        cfg.MODEL.ROI_HEADS.POOLER_IMPL = impl
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.001
        model = damped_init(build_model(cfg), seed=0)
        model(batch)  # warm-up
        torch.cuda.synchronize()
        ra.roi_align_band.launches = ra.roi_align_paired.launches = 0
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            dets = model(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        n = ra.roi_align_band.launches, ra.roi_align_paired.launches
        if n != ((iters, 0) if impl == "pallas_fast" else (0, iters)):
            raise AssertionError(f"C4 serving {impl}: K1/K2 launches {n} over {iters} forwards")
        check_detections(dets, B)
        if not dets.valid.any(dim=1).all():
            raise AssertionError(f"C4 serving {impl}: an image kept no detection ({dets.valid.sum(dim=1).tolist()})")
        with rec:
            model(batch)
        if impl == "auto":
            with torch.no_grad():
                res4 = model.backbone(model.model_images(batch))["res4"].float().permute(0, 2, 3, 1)
                semantics = wide_box_distance(res4, model.proposals(batch)[0])
        serving.append(f"{impl} {ms:.2f} ms/batch ({B * 1e3 / ms:.2f} img/s), K1/K2 {n[0]}/{n[1]}, "
                       f"valid detections {dets.valid.sum(dim=1).tolist()} of {dets.valid.shape[1]} slots an image")
        del model
        torch.cuda.empty_cache()
    print(f"C4 serving: R-50-C4 bf16 B={B} at {H}x{W}: " + "; ".join(serving) + f" {tag}")
    print(f"C4 pools against the exact gather (float32 res4 of the auto forward, its proposals plus 8 boxes an "
          f"image wider than the paired window, P=14, grid <= 2): {semantics} {tag}")

    n_train, n_test = TRAIN_NET_TREE
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        write_coco_tree(root, n_train, n_test, sizes=((480, 640), (640, 480)), seed=0, max_boxes=8)
        use_coco_tree(root)
        model = damped_init(build_model(c4_cfg()), seed=0)
        weights = DetectionCheckpointer(model, os.path.join(tmp, "weights")).save("damped_init", iteration=0)
        del model
        opts = ["MODEL.BACKBONE.NAME", "build_resnet_backbone", "MODEL.WEIGHTS", weights,
                "MODEL.ROI_HEADS.POOLER_IMPL", "pallas_train", "SOLVER.AMP.ENABLED", "True",
                "SOLVER.IMS_PER_BATCH", str(B), "SOLVER.BASE_LR", "1e-4", "SOLVER.MAX_ITER", str(C4_ITERS),
                "SOLVER.CHECKPOINT_PERIOD", "1000000", "DATASETS.TRAIN", "('coco_trainval_all',)",
                "DATASETS.FS_TRAIN", "('coco_trainval_all',)", "DATASETS.TEST", "('coco_test_all',)",
                "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.001", "SEED", "0",
                "OUTPUT_DIR", os.path.join(tmp, "out")]
        torch.cuda.reset_peak_memory_stats()
        res, secs, n, trainer = run_cli(train_net, opts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        c = trainer.cfg
        if (c.MODEL.ROI_HEADS.NAME, c.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION, tuple(c.MODEL.ROI_HEADS.IN_FEATURES),
                c.MODEL.RPN.PRE_NMS_TOPK_TEST, c.MODEL.RPN.POST_NMS_TOPK_TEST) != ("Res5ROIHeads", 14, ("res4",),
                                                                                   6000, 1000):
            raise AssertionError("the phase must run the C4 defaults")
        if set(trainer.step_launches) != {(1, 1)} or n[1:] != (C4_ITERS + n_test, C4_ITERS):
            raise AssertionError(f"C4 train_net: K2/K3 per iteration {sorted(set(trainer.step_launches))}, all {n}")
        result = result_rows(os.path.join(tmp, "out", "inference", "coco_instances_test_results.json"))
        if not (res["bbox"]["AP"] >= 0) or not result:
            raise AssertionError(f"C4 train_net: no bbox AP or no result rows: {res}, {len(result)} rows")
        print(f"C4 train_net: R-50-C4 (Res5ROIHeads, P=14, res4 1024 wide) AMP POOLER_IMPL pallas_train, "
              f"IMS_PER_BATCH {B} at 832x1344, bbox AP {res['bbox']['AP']:.4f} of {len(result)} result rows on "
              f"{n_test} images {tag}")
        train_net_report("C4 train_net", trainer, secs, peak, B, tag)
        with rec:
            trainer.run_step()
        del trainer
    if [len(rec.band), len(rec.fwd), len(rec.bwd)] != [1, 2, 1] or any(
            len(levels) != 1 or taps.rows.shape[1] != 14 or levels[0].shape[-1] != 1024
            for levels, taps in rec.band + rec.fwd):
        raise AssertionError(f"C4: recorded K1/K2/K3 calls {len(rec.band)}/{len(rec.fwd)}/{len(rec.bwd)}")
    return check_recorded_pool("C4 path (P=14, one level, C=1024)", rec, tag, timed=True)


# ---------------------------------------------------------------------------
# PASCAL VOC and LVIS data and evaluation, the context detector,
# PrecomputedProposals, DefaultPredictor, the crop loaders, RPNComp and the
# clustering (phases 28-31)
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
BASE_YAML = os.path.join(REPO, "configs", "Base-RCNN-FPN.yaml")
VOC_TREE = (40, 12, 24)  # VOC2007 trainval, VOC2007 test and VOC2012 trainval images
VOC_ITERS = 8  # each VOC training run: 3 warm-up iterations and 5 timed
CONTEXT_ITERS = 8
VOC_MIN_SIZES = "(480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)"  # TFA's PascalVOC-detection configs
KMEANS = dict(n=50000, dim=384, pca=256, k=100, iters=20)  # the verifier's descriptor scale


class FanOut:
    """Several evaluators fed the same model outputs; ``evaluate`` returns
    each one's results, in order."""

    def __init__(self, *evaluators):
        self.evaluators = evaluators

    def reset(self):
        for e in self.evaluators:
            e.reset()

    def process_detections(self, out, metas):
        for e in self.evaluators:
            e.process_detections(out, metas)

    def evaluate(self):
        return [e.evaluate() for e in self.evaluators]


def lvis_json_from_coco(coco_json: str, out: str) -> str:
    """A COCO json rewritten as an LVIS json: the same images, boxes and
    categories; ``frequency`` r, c, f in turn over the categories in id
    order; ``neg_category_ids`` every category absent from the image and
    ``not_exhaustive_category_ids`` empty, so that the LVIS ignore rule
    changes nothing."""
    with open(coco_json) as f:
        data = json.load(f)
    cats = sorted(data["categories"], key=lambda c: c["id"])
    present = {}
    for a in data["annotations"]:
        present.setdefault(a["image_id"], set()).add(a["category_id"])
    data["categories"] = [dict(c, frequency="rcf"[k % 3]) for k, c in enumerate(cats)]
    data["images"] = [dict(img, neg_category_ids=[c["id"] for c in cats if c["id"] not in present.get(img["id"], ())],
                           not_exhaustive_category_ids=[]) for img in data["images"]]
    with open(out, "w") as f:
        json.dump(data, f)
    return out


def replace_dataset(name: str, register, *args) -> None:
    """(Re)register ``name`` in the port's catalog."""
    from lvc_tpu_torch.data.catalog import DatasetCatalog

    if name in DatasetCatalog:
        DatasetCatalog.remove(name)
    register(name, *args)


def gate_voc_tree(paths, root: str):
    """Phase 18's 60 held-out drawn images as a VOC 2007 test tree under
    ``root`` (JPEGs, XML, ``ImageSets/Main/test.txt``; disc is the base
    class, slab the novel one), plus a COCO json and an LVIS json of the same
    JPEGs and boxes; each registered in the port's catalog. Returns the
    three dataset names."""
    from PIL import Image

    from lvc_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from lvc_tpu_torch.data.meta_coco import load_coco_json
    from lvc_tpu_torch.data.meta_lvis import register_meta_lvis
    from lvc_tpu_torch.data.meta_pascal_voc import register_meta_pascal_voc
    from lvc_tpu_torch.tools import verify_synthetic_ap as gate

    with open(paths["val"]["json"]) as f:
        gt = json.load(f)
    base = os.path.join(root, "VOC2007")
    img_dir = os.path.join(base, "JPEGImages")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(base, "ImageSets", "Main"), exist_ok=True)
    anns = {}
    for a in gt["annotations"]:
        anns.setdefault(a["image_id"], []).append(a)
    ids = []
    for img in gt["images"]:
        fid = f"{img['id']:06d}"
        ids.append(fid)
        Image.open(os.path.join(paths["val"]["images"], img["file_name"])).convert("RGB").save(
            os.path.join(img_dir, fid + ".jpg"), quality=95)
        voc_xml(os.path.join(base, "Annotations", fid + ".xml"), img["height"], img["width"],
                [(gate.CLASSES[a["category_id"] - 1], a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                  a["bbox"][1] + a["bbox"][3], False) for a in anns.get(img["id"], [])])
        img["file_name"] = fid + ".jpg"
    with open(os.path.join(base, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    coco_json = os.path.join(root, "coco_test.json")
    with open(coco_json, "w") as f:
        json.dump(gt, f)
    classes = list(gate.CLASSES)
    voc = "synth_voc_2007_test"
    replace_dataset(voc, register_meta_pascal_voc, {"thing_classes": {1: classes}, "base_classes": {1: classes[:1]},
                                                   "novel_classes": {1: classes[1:]}}, base, "test", 2007,
                    "base_novel_1", 1)
    coco = "synth_voc_coco_test"
    meta = {"thing_classes": classes, "thing_dataset_id_to_contiguous_id": {1: 0, 2: 1}}
    replace_dataset(coco, DatasetCatalog.register, lambda: load_coco_json(coco_json, img_dir, meta, coco))
    MetadataCatalog.get(coco).set(json_file=coco_json, image_root=img_dir, evaluator_type="coco", **meta)
    lvis = "synth_voc_lvis_test"
    replace_dataset(lvis, register_meta_lvis, {}, lvis_json_from_coco(coco_json, os.path.join(root, "lvis.json")),
                    img_dir)
    return voc, coco, lvis


def voc_gate_check(tag, gate_pth: str):
    """Phase 28, the VOC evaluator's accuracy check: phase 18's trained
    float32 gate model (``gate_pth``) over its 60 held-out images written as
    a VOC 2007 tree, one forward an image (K2 once each), the same detections
    fed to ``PascalVOCDetectionEvaluator``, ``COCOEvaluator`` and
    ``LVISEvaluator``. The VOC AP50 must pass the gate's ``verify_results``
    (in (60, 100)); the LVIS AP must equal the COCO AP within 1e-6 (no image
    has more than 100 detections and every absent category is listed as
    negative, so neither maxDets 300 nor the ignore rule changes a row)."""
    import tempfile

    import torch

    from lvc_tpu_torch.data.build import build_detection_test_loader
    from lvc_tpu_torch.evaluation.coco_evaluation import COCOEvaluator
    from lvc_tpu_torch.evaluation.evaluator import inference_on_dataset
    from lvc_tpu_torch.evaluation.lvis_evaluation import LVISEvaluator
    from lvc_tpu_torch.evaluation.pascal_voc_evaluation import PascalVOCDetectionEvaluator
    from lvc_tpu_torch.evaluation.testing import verify_results
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.tools import verify_synthetic_ap as gate

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        voc, coco, lvis = gate_voc_tree(gate.build_dataset(os.path.join(tmp, "synth")), os.path.join(tmp, "voc"))
        tree_s = time.perf_counter() - t0
        cfg = gate.make_cfg(False, GATE_ITERS["f32"], os.path.join(tmp, "out"))
        cfg.DATASETS.TEST = (voc,)
        model = build_model(cfg)
        model.load_state_dict(torch.load(gate_pth, map_location="cuda"))
        loader = build_detection_test_loader(cfg, voc, batch_size=1)
        evaluators = FanOut(PascalVOCDetectionEvaluator(voc), COCOEvaluator(coco, cfg, os.path.join(tmp, "coco")),
                            LVISEvaluator(lvis, cfg, os.path.join(tmp, "lvis")))
        ra.roi_align_paired.launches = 0
        t0 = time.perf_counter()
        res_voc, res_coco, res_lvis = inference_on_dataset(model, loader, evaluators)
        secs = time.perf_counter() - t0
        launches = ra.roi_align_paired.launches
    v, c, lv = res_voc["bbox"], res_coco["bbox"], res_lvis["bbox"]
    ok = verify_results(cfg, {"bbox": v})
    lvis_err = max(abs(lv[k] - c[k]) for k in ("AP", "AP50", "AP75", "APs", "APm", "APl"))
    print(f"VOC evaluation of the trained float32 gate model (60 held-out images as a VOC 2007 tree, written in "
          f"{tree_s:.1f} s; {secs:.2f} s for the forwards and three evaluators, K2 launches {launches}): VOC AP50 "
          f"{v['AP50']:.4f} (11-point, +1-pixel IoU), COCO AP50 {c['AP50']:.4f}, VOC - COCO {v['AP50'] - c['AP50']:+.4f}; "
          f"VOC AP {v['AP']:.4f} AP75 {v['AP75']:.4f} bAP50 (disc) {v['bAP50']:.4f} nAP50 (slab) {v['nAP50']:.4f}; "
          f"COCO AP {c['AP']:.4f}; LVIS AP {lv['AP']:.4f} APr {lv['APr']:.4f} APc {lv['APc']:.4f}, largest "
          f"|LVIS - COCO| over AP..APl {lvis_err:.3e} (tol 1e-6); verify_results {'PASS' if ok else 'FAIL'} {tag}")
    if not ok or not 60 < v["AP50"] < 100:
        raise AssertionError(f"VOC AP50 {v['AP50']} is not in (60, 100)")
    if lvis_err > 1e-6 or launches != 60:
        raise AssertionError(f"LVIS against COCO {lvis_err} on the gate model, K2 launches {launches}")


def use_voc_tree(root: str) -> None:
    """Register every VOC name on the tree at ``root`` (the ``datasets``
    directory), as ``register_all_pascal_voc(root)`` registers them at import
    under ``$DETECTRON2_DATASETS``."""
    from lvc_tpu_torch.data import builtin
    from lvc_tpu_torch.data.catalog import DatasetCatalog

    for name in [n for n in DatasetCatalog.list() if n.startswith("voc_")]:
        DatasetCatalog.remove(name)
    builtin.register_all_pascal_voc(root)


def voc_opts(weights: str, out: str):
    """ucbdrive/few-shot-object-detection's
    ``configs/PascalVOC-detection/split1/faster_rcnn_R_101_FPN_base1.yaml``
    on ``Base-RCNN-FPN.yaml``: R-101, 15 classes, TFA's train sizes, the
    07+12 base1 splits, IMS_PER_BATCH 16, steps (12000, 16000), warm-up 100;
    with AMP and POOLER_IMPL pallas_train; cut to ``VOC_ITERS`` iterations,
    BASE_LR 1e-4 (phase 17's, for a random init) and the score threshold
    0.001, so that the random detector's rows reach the evaluator."""
    return ["--config-file", BASE_YAML, "MODEL.RESNETS.DEPTH", "101", "MODEL.ROI_HEADS.NUM_CLASSES", "15",
            "INPUT.MIN_SIZE_TRAIN", VOC_MIN_SIZES, "INPUT.MAX_SIZE_TRAIN", "1333", "INPUT.MIN_SIZE_TEST", "800",
            "DATASETS.TRAIN", "('voc_2007_trainval_base1', 'voc_2012_trainval_base1')",
            "DATASETS.TEST", "('voc_2007_test_base1',)", "SOLVER.IMS_PER_BATCH", "16",
            "SOLVER.STEPS", "(12000, 16000)", "SOLVER.WARMUP_ITERS", "100", "SOLVER.BASE_LR", "1e-4",
            "SOLVER.MAX_ITER", str(VOC_ITERS), "SOLVER.CHECKPOINT_PERIOD", "1000000", "SOLVER.AMP.ENABLED", "True",
            "MODEL.ROI_HEADS.POOLER_IMPL", "pallas_train", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.001",
            "MODEL.WEIGHTS", weights, "SEED", "0", "OUTPUT_DIR", out]


def ft_opts(weights: str, out: str):
    """``faster_rcnn_R_101_FPN_ft_all1_1shot.yaml`` on top of ``voc_opts``:
    20 classes from the randinit surgery, the 1-shot all1 split, backbone and
    RPN frozen and ``FREEZE_FEAT`` (only the box predictor trains), BASE_LR
    0.001, steps (3000,), no warm-up; cut to ``VOC_ITERS`` iterations. The
    LVC training-set merge filters an "all" split of ``UNSEEN_CLASSES`` and
    adds ``FS_TRAIN`` filtered of ``SEEN_CLASSES`` (both packages'
    ``get_dataset_dicts_all``): given split 1's classes and the same 1-shot
    set, it trains on that set, as TFA does."""
    from lvc_tpu_torch.data.builtin_meta import PASCAL_VOC_BASE_CATEGORIES, PASCAL_VOC_NOVEL_CATEGORIES

    opts = voc_opts(weights, out)
    for key, value in (("MODEL.ROI_HEADS.NUM_CLASSES", "20"), ("DATASETS.TRAIN", "('voc_2007_trainval_all1_1shot',)"),
                       ("DATASETS.TEST", "('voc_2007_test_all1',)"), ("SOLVER.BASE_LR", "0.001"),
                       ("SOLVER.STEPS", "(3000,)"), ("SOLVER.WARMUP_ITERS", "0")):
        opts[opts.index(key) + 1] = value
    return opts + ["MODEL.BACKBONE.FREEZE", "True", "MODEL.PROPOSAL_GENERATOR.FREEZE", "True",
                   "MODEL.ROI_HEADS.FREEZE_FEAT", "True", "DATASETS.FS_TRAIN", "('voc_2007_trainval_all1_1shot',)",
                   "DATASETS.SEEN_CLASSES", repr(PASCAL_VOC_BASE_CATEGORIES[1]),
                   "DATASETS.UNSEEN_CLASSES", repr(PASCAL_VOC_NOVEL_CATEGORIES[1])]


def last_checkpoint(out: str) -> str:
    with open(os.path.join(out, "last_checkpoint")) as f:
        return os.path.join(out, f.read().strip())


def voc_path(tag):
    """Phase 29, VOC at full width, TFA split 1, on a seeded VOC tree
    (``VOC_TREE`` images at VOC's 500x375 and 375x500, some objects
    difficult, 1-shot lists) written under ``<tmp>/datasets``, run from
    ``<tmp>`` (the few-shot lists are read relative to the working
    directory): ``train_net`` on the 07+12 base1 splits (15 classes,
    ``voc_opts``) from a damped-init ``.pth``, ``--eval-only`` on
    voc_2007_test_base1, ``ckpt_surgery --method randinit`` to 20 classes,
    the 1-shot ``ft_all1`` fine-tune (``ft_opts``) and ``--eval-only`` on
    voc_2007_test_all1, which must report bAP50 and nAP50. K2/K3 every
    training step (K3 0 when nothing before the pool trains), held to their
    plain versions on one more base step's own tensors."""
    import tempfile

    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.tools import ckpt_surgery, train_net
    from lvc_tpu_torch.utils.init import damped_init

    cwd = os.getcwd()
    rec = PoolRecorder()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_voc_tree(os.path.join(tmp, "datasets"), *VOC_TREE, seed=0)
        use_voc_tree(os.path.join(tmp, "datasets"))
        tree_s = time.perf_counter() - t0
        os.chdir(tmp)
        try:
            cfg = get_cfg()
            cfg.merge_from_file(BASE_YAML)
            cfg.merge_from_list(voc_opts("", "")[2:])
            model = damped_init(build_model(cfg), seed=0)
            weights = DetectionCheckpointer(model, os.path.join(tmp, "weights")).save("damped_init", iteration=0)
            del model
            runs = {}
            for what, argv in (("base1 train_net", voc_opts(weights, "base")),):
                torch.cuda.reset_peak_memory_stats()
                res, secs, n, trainer = run_cli(train_net, argv)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                if set(trainer.step_launches) != {(1, 1)} or trainer.cfg.MODEL.RESNETS.DEPTH != 101:
                    raise AssertionError(f"VOC base1: K2/K3 per iteration {sorted(set(trainer.step_launches))}")
                ms = train_net_report(f"VOC {what}: R-101-FPN, 15 classes, AMP, pallas_train, IMS_PER_BATCH 16, "
                                      f"VOC sizes (tree written in {tree_s:.1f} s)", trainer, secs, peak, 16, tag)
                profile_call(trainer.run_step, ms, "VOC base1 iteration (loader wait, B=16 AMP step)", tag,
                             stages=TRAIN_STAGES)
                with rec:
                    trainer.run_step()
                runs[what] = res
                del trainer
            base_final = last_checkpoint("base")
            res, secs, n, ev = run_cli(train_net, ["--eval-only"] + voc_opts(base_final, "base_eval"))
            n_test = VOC_TREE[1]
            final = runs["base1 train_net"]["bbox"]
            err = max(abs(res["bbox"][k] - v) for k, v in final.items())
            if err > 1e-9 or n[1] != n_test or "AP50-aeroplane" not in res["bbox"]:
                raise AssertionError(f"VOC --eval-only {res} differs from the final evaluation, K2 {n[1]}")
            print(f"VOC --eval-only voc_2007_test_base1: {ev.test_s / n_test * 1e3:.2f} ms/img end to end at batch 1 "
                  f"({n_test} images at 800x1067 or 1067x800 on the 832x1344 canvases; K2 {n[1]}), AP {res['bbox']['AP']:.4f} "
                  f"AP50 {res['bbox']['AP50']:.4f}, the training's final evaluation within {err:.1e} {tag}")
            surgery = ckpt_surgery.main(ckpt_surgery.parser.parse_args(
                ["--src1", base_final, "--method", "randinit", "--save-dir", "surgery"]))
            torch.cuda.reset_peak_memory_stats()
            res, secs, n, trainer = run_cli(train_net, ft_opts(surgery, "ft"))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            trains_features = any(p.requires_grad for name, p in trainer.model.named_parameters()
                                  if name.startswith("backbone."))
            want = {(1, int(trains_features))}
            if set(trainer.step_launches) != want or trainer.cfg.MODEL.ROI_HEADS.NUM_CLASSES != 20:
                raise AssertionError(f"VOC ft_all1: K2/K3 per iteration {sorted(set(trainer.step_launches))}, want {want}")
            train_net_report("VOC ft_all1 1-shot train_net: randinit surgery to 20 classes, FREEZE_FEAT (backbone and "
                             f"RPN frozen: pool inputs {'train' if trains_features else 'frozen'})", trainer, secs, peak,
                             16, tag)
            del trainer
            res, secs, n, ev = run_cli(train_net, ["--eval-only"] + ft_opts(last_checkpoint("ft"), "ft_eval"))
            b = res["bbox"]
            if not {"bAP50", "nAP50", "AP50-bird"} <= set(b) or n[1] != n_test:
                raise AssertionError(f"VOC ft_all1 --eval-only: {res}, K2 {n[1]}")
            print(f"VOC --eval-only voc_2007_test_all1 after the fine-tune: {ev.test_s / n_test * 1e3:.2f} ms/img, AP "
                  f"{b['AP']:.4f} AP50 {b['AP50']:.4f} bAP50 {b['bAP50']:.4f} nAP50 {b['nAP50']:.4f} (a random "
                  f"detector trained {VOC_ITERS} iterations) {tag}")
        finally:
            os.chdir(cwd)
    return check_recorded_pool("VOC base1 step (R-101-FPN, AMP, 512 boxes an image)", rec, tag, timed=True)


def coco_tree_for(root: str) -> None:
    """Phase 17's seeded COCO tree again (``write_coco_tree`` with its
    arguments writes the same files), registered in the port's catalog."""
    n_train, n_test = TRAIN_NET_TREE
    write_coco_tree(root, n_train, n_test, sizes=((480, 640), (640, 480)), seed=0, max_boxes=8)
    use_coco_tree(root)


def lvis_path(tag, root: str, base_pth: str):
    """Phase 30: phase 17's test split rewritten as an LVIS json
    (``lvis_json_from_coco``: the same images, boxes and 80 categories,
    frequency r/c/f in turn, every absent category negative, none
    not-exhaustive) and registered with ``register_meta_lvis``;
    ``train_net --eval-only`` from phase 17's ``base.pth`` with the
    ``LVISEvaluator`` on it, and with the ``COCOEvaluator`` on coco_test_all
    (the same 80-category map). The two result files must hold the same
    rows, and the LVIS AP..APl must equal COCO's all-split values within
    1e-6: on this json the ignore rule and maxDets 300 change nothing."""
    from lvc_tpu_torch.data.meta_lvis import register_meta_lvis
    from lvc_tpu_torch.tools import train_net

    lvis_json = lvis_json_from_coco(os.path.join(root, "cocosplit", "datasplit", "5k.json"),
                                    os.path.join(root, "lvis_test.json"))
    replace_dataset("lvis_coco_test", register_meta_lvis, {}, lvis_json, os.path.join(root, "coco", "val2014"))
    out = {}
    for name, results in (("lvis_coco_test", "lvis_instances_results.json"),
                          ("coco_test_all", "coco_instances_test_results.json")):
        work = os.path.join(os.path.dirname(root), name)
        res, secs, n, ev = run_cli(train_net, [
            "--config-file", TRAIN_NET_YAML, "--eval-only", "MODEL.WEIGHTS", base_pth,
            "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.001", "DATASETS.TEST", f"('{name}',)", "OUTPUT_DIR", work])
        out[name] = res["bbox"], result_rows(os.path.join(work, "inference", results)), ev.test_s, n[1]
    (lv, lv_rows, lv_s, k2), (co, co_rows, co_s, _) = out["lvis_coco_test"], out["coco_test_all"]
    keys = ("AP", "AP50", "AP75", "APs", "APm", "APl")
    err = max(abs(lv[k] - co[k]) for k in keys)
    n_test = TRAIN_NET_TREE[1]
    print(f"LVIS --eval-only of phase 17's base.pth on its test split as an LVIS json: {len(lv_rows)} rows "
          f"({'equal to' if lv_rows == co_rows else 'NOT equal to'} the COCO run's {len(co_rows)}), LVIS AP "
          f"{lv['AP']:.6f} AP50 {lv['AP50']:.6f} APr {lv['APr']:.6f} APc {lv['APc']:.6f} APf {lv['APf']:.6f}; COCO "
          f"all-split AP {co['AP']:.6f} AP50 {co['AP50']:.6f}; largest |LVIS - COCO| over AP..APl {err:.3e} (tol "
          f"1e-6); {lv_s / n_test * 1e3:.2f} (LVIS) and {co_s / n_test * 1e3:.2f} (COCO) ms/img, K2 {k2} {tag}")
    if lv_rows != co_rows or err > 1e-6 or k2 != n_test or not lv_rows:
        raise AssertionError(f"LVIS against COCO: rows equal {lv_rows == co_rows}, AP diff {err}, K2 {k2}")


def context_path(tag, base_pth: str):
    """Phase 31a: ``GeneralizedRCNN_Context`` through ``train_net.main`` at
    phase 17's width (faster_rcnn_R_50_FPN_base.yaml, AMP, IMS_PER_BATCH 16
    at 832x1344, POOLER_IMPL auto: K2 and K3 in training) from phase 17's
    ``base.pth`` (the context head starts from the trainer's He init), on
    phase 17's tree for ``CONTEXT_ITERS`` iterations, then its evaluation
    through the COCO evaluator (which reads the dict's detections); one more
    test batch's eval output must hold finite ``image_scores`` in [0, 1];
    K2/K3 on one more step's own tensors against their plain versions."""
    import tempfile

    import torch

    from lvc_tpu_torch.tools import train_net

    rec = PoolRecorder()
    with tempfile.TemporaryDirectory() as tmp:
        opts = ["--config-file", TRAIN_NET_YAML, "MODEL.META_ARCHITECTURE", "GeneralizedRCNN_Context",
                "MODEL.WEIGHTS", base_pth, "SOLVER.AMP.ENABLED", "True", "SOLVER.BASE_LR", "1e-4",
                "SOLVER.MAX_ITER", str(CONTEXT_ITERS), "SOLVER.CHECKPOINT_PERIOD", "1000000", "SEED", "0",
                "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.001", "OUTPUT_DIR", tmp]
        torch.cuda.reset_peak_memory_stats()
        res, secs, n, trainer = run_cli(train_net, opts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(tmp, "metrics.json")) as f:
            rows = [json.loads(line) for line in f]
        loss = [r["loss_context"] for r in rows if "loss_context" in r]
        if set(trainer.step_launches) != {(1, 1)} or not loss or not all(math.isfinite(v) for v in loss):
            raise AssertionError(f"context train_net: K2/K3 {sorted(set(trainer.step_launches))}, loss_context {loss}")
        train_net_report("context train_net: GeneralizedRCNN_Context R-50-FPN (60 classes) AMP, IMS_PER_BATCH 16 at "
                         "832x1344", trainer, secs, peak, 16, tag)
        model = trainer.model.eval()
        batch, metas = next(iter(train_net.Trainer.build_test_loader(trainer.cfg, "coco_test_base")))
        out = model(batch)
        scores = out["image_scores"]
        if (set(out) != {"detections", "image_scores"} or tuple(scores.shape) != (1, 60)
                or not bool(((scores >= 0) & (scores <= 1)).all()) or "AP" not in res["bbox"]):
            raise AssertionError(f"context eval output {set(out)}, image_scores {tuple(scores.shape)}, results {res}")
        print(f"context train_net: loss_context {loss[-1]:.6f} in the last metrics.json row; its evaluation "
              f"through the COCO evaluator bbox AP {res['bbox']['AP']:.4f} ({trainer.test_s:.2f} s, K2 "
              f"{trainer.test_launches[0]}); image_scores of one test image: shape {tuple(scores.shape)}, mean "
              f"{float(scores.mean()):.4f}, max {float(scores.max()):.4f} {tag}")
        model.train()
        with rec:
            trainer.run_step()
        del trainer
    return check_recorded_pool("context step (R-50-FPN, AMP, 512 boxes an image)", rec, tag, timed=True)


def context_reference_check(tag):
    """Phase 31's narrow check: one train step of ``GeneralizedRCNN_Context``
    at ``narrow_cfg``'s widths (float32, POOLER_IMPL pallas_train,
    exhaustive sampling, phase 21's batch) on the card (K2 + K3) and on the
    CPU (plain versions) from the same weights: every loss to rel 1e-4 and
    every gradient to rel L2 1e-4 (phase 21's tolerances), K2/K3 1/1; the
    eval output's ``image_scores`` to 1e-5 and its detections as phase 3's;
    then K2 and K3 on the card step's own tensors against their plain
    versions."""
    import torch

    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer

    batch = train_batch(2, 128, 192, 4, seed=3, device="cpu", num_classes=5, n_gt=(3, 3), size=(24, 100))
    cfg = narrow_cfg("pallas_train")
    cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNN_Context"
    for key, value in (("PRE_NMS_TOPK_TRAIN", 200), ("POST_NMS_TOPK_TRAIN", 100), ("BATCH_SIZE_PER_IMAGE", 8192),
                       ("POSITIVE_FRACTION", 0.999), ("PRE_NMS_TOPK_TEST", 200), ("POST_NMS_TOPK_TEST", 100)):
        setattr(cfg.MODEL.RPN, key, value)
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 128
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.999
    cfg.TEST.DETECTIONS_PER_IMAGE = 30
    cfg.SOLVER.WARMUP_ITERS = 0
    cpu = build_model(cfg, device="cpu")
    calibrated_init(cpu, seed=0)
    gpu = build_model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    res, rec = {}, PoolRecorder()
    for key, model in (("cpu", cpu), ("gpu", gpu)):
        with torch.no_grad():
            out = model.eval()({k: batch[k] for k in ("image", "image_size")})
        model.train()
        opt = build_optimizer(cfg, model)
        step = make_train_step(model, opt, build_lr_schedule(cfg, opt))
        ra.roi_align_paired.launches = ra.roi_align_paired_bwd.launches = 0
        with rec if key == "gpu" else contextlib.nullcontext():
            metrics = step(batch, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters() if p.grad is not None}
        res[key] = ({k: float(v) for k, v in metrics.items()}, grads,
                    (ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches),
                    out["image_scores"].cpu(), [t.cpu() for t in out["detections"][:5]])
    (c_loss, c_grad, c_n, c_s, c_d), (g_loss, g_grad, g_n, g_s, g_d) = res["cpu"], res["gpu"]
    loss_err = max(abs(g_loss[k] - v) / max(abs(v), 1e-30) for k, v in c_loss.items())
    if c_n != (0, 0) or g_n != (1, 1) or set(c_loss) != set(g_loss) or loss_err > 1e-4 or c_loss["loss_context"] <= 0:
        raise AssertionError(f"context step: K2/K3 {g_n}, losses cpu {c_loss} card {g_loss}")
    rel = {n: float((g_grad[n] - w).norm() / w.norm().clamp(min=1e-30)) for n, w in c_grad.items()}
    worst = max(rel, key=rel.get)
    score_err = float((g_s - c_s).abs().max())
    dv = c_d[3]
    if (rel[worst] > 1e-4 or set(c_grad) != set(g_grad) or "cont_cls.weight" not in c_grad or score_err > 1e-5
            or not torch.equal(dv, g_d[3]) or not torch.equal(c_d[2][dv], g_d[2][dv])
            or float((c_d[0][dv] - g_d[0][dv]).abs().max()) > 1e-3):
        raise AssertionError(f"context: grads {worst} {rel[worst]}, image_scores {score_err}, detections differ")
    print(f"context reference (GeneralizedRCNN_Context, narrow R-50-FPN, 5 classes): card vs CPU at float32, losses "
          f"{ {k: round(v, 5) for k, v in c_loss.items()} } max rel err {loss_err:.2e} (tol 1e-4); {len(rel)} grads "
          f"max rel L2 {rel[worst]:.2e} ({worst}; tol 1e-4); image_scores max err {score_err:.2e} (tol 1e-5); "
          f"{int(dv.sum())} detections equal in class; K2/K3 launches {g_n[0]}/{g_n[1]} {tag}")
    check_recorded_pool("context reference step (float32, C=64)", rec, tag)


def voc_card_evaluation(tag):
    """The VOC evaluator on detections made on the card: phase 3's narrow
    model (``calibrated_init``, 5 classes, float32, POOLER_IMPL pallas: K2)
    over a small seeded VOC tree's 2007 test split, registered as 5 classes
    of split 1, on the card and, from the same weights, on the CPU (the
    plain pool). Every batch's detections as phase 3 holds them (validity
    and class equal, boxes 1e-3 px, scores 1e-4) and one K2 launch a batch;
    ``PascalVOCDetectionEvaluator`` fed the card's tensors gives every
    result of the CPU's within 0.1 AP points (near-tied scores may swap
    places in the ranking)."""
    import tempfile

    import torch

    from lvc_tpu_torch.data.build import build_detection_test_loader
    from lvc_tpu_torch.data.meta_pascal_voc import register_meta_pascal_voc
    from lvc_tpu_torch.evaluation.pascal_voc_evaluation import PascalVOCDetectionEvaluator
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra

    cfg = narrow_cfg("pallas")
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 96, 192
    cfg.PAD.CANVAS_BUCKETS = [[128, 192], [192, 128]]
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.001
    cpu = build_model(cfg, device="cpu")
    calibrated_init(cpu, seed=0)
    gpu = build_model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    with tempfile.TemporaryDirectory() as tmp:
        write_voc_tree(os.path.join(tmp, "datasets"), 4, 6, 0, sizes=((96, 128), (128, 96)))
        classes = ["bird", "bus", "cow", "motorbike", "sofa"]
        replace_dataset("voc_card_probe", register_meta_pascal_voc, {
            "thing_classes": {1: classes}, "base_classes": {1: classes[:3]}, "novel_classes": {1: classes[3:]}},
            os.path.join(tmp, "datasets", "VOC2007"), "test", 2007, "base_novel_1", 1)
        card, host = PascalVOCDetectionEvaluator("voc_card_probe"), PascalVOCDetectionEvaluator("voc_card_probe")
        ra.roi_align_paired.launches = n = 0
        box_err = score_err = 0.0
        for batch, metas in build_detection_test_loader(cfg, "voc_card_probe", batch_size=2):
            g, c = gpu(batch), cpu(batch)
            card.process_detections(g, metas)
            host.process_detections(c, metas)
            g = [t.cpu() for t in g[:5]]
            dv = c.valid
            if not torch.equal(dv, g[3]) or not torch.equal(c.classes[dv], g[2][dv]):
                raise AssertionError("VOC on the card: detections differ from the CPU's in validity or class")
            if dv.any():
                box_err = max(box_err, float((c.boxes[dv] - g[0][dv]).abs().max()))
                score_err = max(score_err, float((c.scores[dv] - g[1][dv]).abs().max()))
            n += sum(not m["padding"] for m in metas)
        want, got = host.evaluate()["bbox"], card.evaluate()["bbox"]
    ap_err = max(abs(got[k] - v) for k, v in want.items())
    if (set(got) != set(want) or ap_err > 0.1 or box_err > 1e-3 or score_err > 1e-4
            or ra.roi_align_paired.launches != 3 or n != 6):
        raise AssertionError(f"VOC on card detections: {got} vs the CPU's {want}, box err {box_err}, score err "
                             f"{score_err}, K2 {ra.roi_align_paired.launches}")
    print(f"VOC evaluator on card detections: {n} images, card vs CPU box err {box_err:.2e} (tol 1e-3) score err "
          f"{score_err:.2e} (tol 1e-4); AP50 {got['AP50']:.4f} (CPU {want['AP50']:.4f}), {len(want)} results max "
          f"diff {ap_err:.2e} points (tol 0.1); K2 launches {ra.roi_align_paired.launches} (batches of 2) {tag}")


def precomputed_proposals_check(tag):
    """Phase 31b: phase 4's R-101-FPN serving model (bf16, pallas_fast,
    seeded damped weights) on a B=2 832x1344 batch at score threshold 0.001;
    its RPN's proposals fed back through a ``PrecomputedProposals`` model
    with the same weights (no proposal generator): the detections must be
    equal slot for slot."""
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.utils.init import damped_init

    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, W = 2, 832, 1344
    batch = {"image": torch.rand(B, H, W, 3, generator=g, device="cuda") * 255,
             "image_size": torch.tensor([[H, W], [800, 1200]], dtype=torch.int32, device="cuda")}
    cfg = serving_cfg("pallas_fast")
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.001
    rpn_model = damped_init(build_model(cfg), seed=0)
    boxes, logits, valid = rpn_model.proposals(batch)
    want = rpn_model(batch)
    cfg.MODEL.PROPOSAL_GENERATOR.NAME = "PrecomputedProposals"
    model = build_model(cfg)
    missing, unexpected = model.load_state_dict(rpn_model.state_dict(), strict=False)
    if missing or not unexpected or not all(k.startswith("proposal_generator.") for k in unexpected):
        raise AssertionError(f"PrecomputedProposals weights: missing {missing}, unexpected {unexpected}")
    got = model(dict(batch, proposal_boxes=boxes, proposal_logits=logits, proposal_valid=valid))
    same = all(a is b is None or torch.equal(a, b) for a, b in zip(got, want))
    print(f"PrecomputedProposals: R-101-FPN bf16 pallas_fast B={B}, {int(valid.sum())} proposals fed back; "
          f"{int(want.valid.sum())} detections, equal slot for slot: {same} {tag}")
    if not same or not bool(want.valid.any()):
        raise AssertionError("PrecomputedProposals: detections differ from the RPN model's")


def predictor_check(tag):
    """Phase 31c: ``DefaultPredictor`` (R-101-FPN, bf16, pallas_fast, on the
    card; ``MODEL.WEIGHTS`` a seeded damped-init checkpoint, loaded over the
    predictor's own He init, which keeps no detection at score threshold
    0.001) on a 500x375 JPEG must keep detections and equal its model's
    forward on the batch the test loader makes from the same file; ms per
    image over 5 calls after a warm-up."""
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.data.build import build_detection_test_loader
    from lvc_tpu_torch.data.catalog import DatasetCatalog
    from lvc_tpu_torch.data.dataset_mapper import read_image
    from lvc_tpu_torch.engine.defaults import DefaultPredictor
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.utils.init import damped_init

    cfg = serving_cfg("pallas_fast")
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.001
    with tempfile.TemporaryDirectory() as tmp:
        cfg.MODEL.WEIGHTS = DetectionCheckpointer(damped_init(build_model(cfg), seed=0), tmp).save("damped", 0)
        rng = np.random.RandomState(2)
        low = rng.randint(0, 256, (375 // 16 + 1, 500 // 16 + 1, 3)).astype(np.uint8)
        path = os.path.join(tmp, "000001.jpg")
        Image.fromarray(np.kron(low, np.ones((16, 16, 1), np.uint8))[:375, :500].copy()).save(path, quality=90)
        record = {"file_name": path, "image_id": 1, "height": 375, "width": 500, "annotations": []}
        replace_dataset("predictor_probe", DatasetCatalog.register, lambda: [record])
        predictor = DefaultPredictor(cfg)
        image = read_image(path, cfg.INPUT.FORMAT)
        got = predictor(image)
        batch, _ = next(iter(build_detection_test_loader(cfg, "predictor_probe")))
        want = predictor.model(batch)
        same = all(a is b is None or np.array_equal(a, b[0].cpu().numpy()) for a, b in zip(got, want))
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            predictor(image)
            times.append(time.perf_counter() - t0)
    print(f"DefaultPredictor: R-101-FPN bf16 on a 500x375 JPEG (800x1067 on the 832x1344 canvas), "
          f"{int(got.valid.sum())} detections, equal to the model's forward on the test loader's batch: {same}; "
          f"{sum(times) / len(times) * 1e3:.2f} ms/image (min {min(times) * 1e3:.2f}) over 5 calls, resize and copy "
          f"included {tag}")
    if not same or not got.valid.any():
        raise AssertionError("DefaultPredictor differs from the model's forward on the loader's batch")


def crops_path(tag, base_pth: str):
    """Phase 31d: ``RPNEvaluator`` (``train_net --eval-only`` with
    ProposalNetwork from phase 17's ``base.pth``) writes the proposal pickle
    of phase 17's test split; ``build_crop_exem_loader`` over it (40
    proposals an image before the filters, the shots from the train split)
    gives batches of 64 proposal crops of 224 plus one shot, fed to RPNComp
    (R-50, res5, avg pool, He init) on the card, and the first batch also on
    the CPU (float32, TF32 off): within rel 1e-4 of the largest |value|;
    crops/s with the loader and of the forwards alone."""
    import tempfile

    import torch

    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.data.crop import build_crop_exem_loader
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.tools import train_net
    from lvc_tpu_torch.utils.init import he_init

    with tempfile.TemporaryDirectory() as tmp:
        run_cli(train_net, ["--config-file", TRAIN_NET_YAML, "--eval-only", "MODEL.META_ARCHITECTURE",
                            "ProposalNetwork", "MODEL.WEIGHTS", base_pth, "DATASETS.TEST", "('coco_test_all',)",
                            "OUTPUT_DIR", tmp])
        cfg = get_cfg()
        cfg.merge_from_list(["DATASETS.FS_TRAIN", "('coco_trainval_all',)", "DATASETS.TEST", "('coco_test_all',)",
                             "DATASETS.PROPOSAL_FILES_TEST", f"('{os.path.join(tmp, 'coco_proposals_test_results.pkl')}',)",
                             "MODEL.LOAD_PROPOSALS", "True", "SOLVER.IMS_PER_BATCH", "65",
                             "DATALOADER.PROPOSALS.TOPK", "40", "MODEL.META_ARCHITECTURE", "RPNComp",
                             "MODEL.BACKBONE.NAME", "build_resnet_backbone", "MODEL.RESNETS.OUT_FEATURES", "['res5']",
                             "MODEL.RPNCOMP.POOLER", "avg"])
        cpu = build_model(cfg, device="cpu")
        he_init(cpu, torch.Generator().manual_seed(0))
        card = build_model(cfg)
        card.load_state_dict(cpu.state_dict())
        loader = build_crop_exem_loader(cfg, "coco_test_all")
        n = fwd_s = 0
        err = None
        t0 = time.perf_counter()
        for batch in loader:
            t1 = time.perf_counter()
            out = card(batch)
            torch.cuda.synchronize()
            fwd_s += time.perf_counter() - t1
            n += len(batch["image"])
            if err is None:
                if tuple(out.shape) != (65, 2048) or batch["annotation"][-1] is None:
                    raise AssertionError(f"RPNComp: {tuple(out.shape)} from a batch of {len(batch['image'])}")
                want = cpu(batch)
                err = float((out.cpu() - want).abs().max() / want.abs().max())
        secs = time.perf_counter() - t0
    print(f"crops and RPNComp: build_crop_exem_loader over RPNEvaluator's pickle, {len(loader)} batches of 64 "
          f"proposal crops + 1 shot at 224x224, RPNComp R-50 res5 avg float32: card vs CPU on the first batch "
          f"max |diff| / max |value| {err:.3e} (tol 1e-4); {n / secs:.1f} crops/s with the loader, "
          f"{n / fwd_s:.1f} crops/s of the forwards alone {tag}")
    if err is None or err > 1e-4:
        raise AssertionError(f"RPNComp card vs CPU: {err}")


def clustering_check(tag):
    """Phase 31e: ``preprocess_features`` (PCA 384 -> 256 with whitening, L2)
    and 20 k-means iterations (k=100) on 50,000 seeded descriptors (100
    clusters, the kept 256 directions with distinct variances, the other 128
    small), on the card and on the CPU from the same initial rows: the
    assignments must be equal away from near-ties (the CPU's gap between the
    two nearest centroids of its last iteration below 1e-3); ``Kmeans`` on
    the card timed."""
    import numpy as np
    import torch

    from lvc_tpu_torch.data.cluster.clustering import Kmeans, init_indices, kmeans_run, preprocess_features

    p = KMEANS
    g = torch.Generator().manual_seed(0)
    centers = torch.randn(p["k"], p["dim"], generator=g)
    labels = torch.randint(p["k"], (p["n"],), generator=g)
    scale = torch.cat([torch.linspace(3.0, 1.0, p["pca"]), torch.full((p["dim"] - p["pca"],), 0.05)])
    x = (centers[labels] + 0.5 * torch.randn(p["n"], p["dim"], generator=g)) * scale
    idx = init_indices(p["n"], p["k"], torch.Generator().manual_seed(1))
    out = {}
    for device in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, _ = preprocess_features(x.to(device), p["pca"])
        cent, _, _ = kmeans_run(feats, feats[idx.to(device)], p["iters"] - 1)
        d2 = (cent ** 2).sum(1)[None] - 2.0 * feats @ cent.T
        torch.cuda.synchronize()
        out[device] = d2.argmin(1).cpu(), d2.cpu(), (time.perf_counter() - t0) * 1e3
    (a_card, _, card_ms), (a_cpu, d2, cpu_ms) = out["cuda"], out["cpu"]
    top2 = d2.topk(2, dim=1, largest=False).values
    tie = (top2[:, 1] - top2[:, 0]) < 1e-3
    differ = a_card != a_cpu
    km = Kmeans(p["k"], pca_dim=p["pca"], n_iter=p["iters"], seed=0)
    xc = x.cuda()
    km.cluster(xc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = km.cluster(xc)
    torch.cuda.synchronize()
    km_ms = (time.perf_counter() - t0) * 1e3
    sizes = np.array([len(c) for c in km.images_lists])
    print(f"clustering: N={p['n']}, D={p['dim']} -> PCA {p['pca']}, k={p['k']}, {p['iters']} iterations from the same "
          f"rows: card {card_ms:.1f} ms, CPU {cpu_ms:.1f} ms; assignments differ on {int(differ.sum())} rows, all "
          f"near-ties: {bool((~differ | tie).all())} ({int(tie.sum())} near-ties, gap < 1e-3); Kmeans.cluster on the "
          f"card {km_ms:.1f} ms (loss {loss:.1f}, cluster sizes {sizes.min()}-{sizes.max()}) {tag}")
    if not bool((~differ | tie).all()) or sizes.sum() != p["n"]:
        raise AssertionError("k-means: card and CPU assignments differ away from near-ties")


# ---------------------------------------------------------------------------
# Mask R-CNN and Keypoint R-CNN, segm evaluation (phases 32-35)
# ---------------------------------------------------------------------------

TASK_ITERS = 10  # each training run of phases 33-34 and 36-38: a warm-up step, then this many timed
MASK_AP_FLOOR = 95.0  # phase 35's oracle masks (the gt cropped to 28 x 28 and pasted back): segm AP at least this
SHIFTED_AP = (50.0, 85.0)  # the same masks moved 3 px right and down: segm AP inside this range
MASK_ROW_IOU = 0.99  # phase 35: a card detection's pasted mask against the CPU's, RLE IoU at least this
CARD = "cuda"  # the device of phases 32-39's card runs
TASK_NAMES = {"mask": "Mask R-CNN R-50-FPN", "keypoint": "Keypoint R-CNN R-50-FPN", "panoptic": "Panoptic FPN R-50",
              "dcn": "Mask R-CNN R-50-FPN DCN c3-c5", "syncbn": "Mask R-CNN R-50-FPN SyncBN"}
MASK_KINDS = ("mask", "panoptic", "dcn", "syncbn")  # the task kinds with a mask head


def task_cfg(kind: str, impl: str = "pallas_fast"):
    """Phases 32-34's and 36-38's full-width configurations, built on
    Base-RCNN-FPN.yaml in code (nothing fetched): ``mask`` follows
    detectron2's model zoo COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml
    (MASK_ON, R-50, 80 classes; the mask head 4 convs 256 wide at P=14, 28 x
    28 masks); ``keypoint`` follows COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml
    on Base-Keypoint-RCNN-FPN.yaml (KEYPOINT_ON, R-50, 1 class, the box head's
    smooth-L1 beta 0.5, 1500 proposals an image in training; the keypoint
    head 8 convs 512 wide at P=14, 17 keypoints on 56 x 56 heatmaps);
    ``retinanet``, ``panoptic`` and ``semantic`` are ``dense_opts``'s;
    ``dcn`` is Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml: ``mask`` with
    deformable 3x3s in res3-res5 (DEFORM_ON_PER_STAGE F,T,T,T, DCN v1);
    ``syncbn`` is Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml (``syncbn_opts``)."""
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(BASE_YAML)
    opts = ["MODEL.RESNETS.DEPTH", 50, "MODEL.ROI_HEADS.POOLER_IMPL", impl]
    if kind in ("mask", "dcn"):
        opts += ["MODEL.MASK_ON", True, "MODEL.ROI_HEADS.NUM_CLASSES", 80]
        if kind == "dcn":
            opts += backbone_opts("dcn")
    elif kind == "syncbn":
        opts += syncbn_opts()
    elif kind == "keypoint":
        opts += ["MODEL.KEYPOINT_ON", True, "MODEL.ROI_HEADS.NUM_CLASSES", 1, "MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA", 0.5,
                 "MODEL.RPN.POST_NMS_TOPK_TRAIN", 1500]
    else:
        opts += dense_opts(kind)
    cfg.merge_from_list(opts)
    return cfg


RETINANET_SIZES = [[x, x * 2 ** (1.0 / 3), x * 2 ** (2.0 / 3)] for x in (32, 64, 128, 256, 512)]
RETINANET_MIN_SIZES = (640, 672, 704, 736, 768, 800)  # Base-RetinaNet.yaml's and semantic_R_50_FPN_1x.yaml's INPUT


def dense_opts(kind: str, narrow: bool = False):
    """The options on Base-RCNN-FPN.yaml of the dense meta-architectures,
    for either package's config: ``retinanet`` is detectron2's model zoo
    COCO-Detection/retinanet_R_50_FPN_1x.yaml on Base-RetinaNet.yaml (R-50,
    res3-res5 into p3-p7 with P6/P7 from res5, 80 classes, the sizes
    ``x * 2**{0, 1/3, 2/3}`` for x in 32-512 with three aspect ratios: 9
    anchors a location, towers of 4 convs 256 wide, IoU 0.4/0.5, smooth-L1
    beta 0, BASE_LR 0.01); ``panoptic`` is
    COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml on
    Base-Panoptic-FPN.yaml (R-50-FPN, MASK_ON with 80 thing classes, the
    semantic head's defaults: 54 classes, 128 wide, GN, common stride 4,
    LOSS_WEIGHT 0.5); ``semantic`` is Misc/semantic_R_50_FPN_1x.yaml
    (R-50-FPN and that head at LOSS_WEIGHT 1). ``narrow``: phase 39's and the
    CPU tests' widths (res2 64, FPN 64, 5 classes, towers 2 convs, the
    semantic head 32 wide over 7 classes, the box head 128, the mask head 2
    convs 32 wide, small top-k sizes and exhaustive sampling)."""
    opts = ["MODEL.RESNETS.DEPTH", 50]
    if kind == "retinanet":
        opts += ["MODEL.META_ARCHITECTURE", "RetinaNet", "MODEL.RESNETS.OUT_FEATURES", ["res3", "res4", "res5"],
                 "MODEL.FPN.IN_FEATURES", ["res3", "res4", "res5"], "MODEL.ANCHOR_GENERATOR.SIZES", RETINANET_SIZES,
                 "MODEL.RETINANET.IOU_THRESHOLDS", [0.4, 0.5], "MODEL.RETINANET.IOU_LABELS", [0, -1, 1],
                 "MODEL.RETINANET.SMOOTH_L1_LOSS_BETA", 0.0, "SOLVER.BASE_LR", 0.01,
                 "INPUT.MIN_SIZE_TRAIN", RETINANET_MIN_SIZES]
    elif kind == "panoptic":
        opts += ["MODEL.META_ARCHITECTURE", "PanopticFPN", "MODEL.MASK_ON", True, "MODEL.ROI_HEADS.NUM_CLASSES", 80,
                 "MODEL.SEM_SEG_HEAD.LOSS_WEIGHT", 0.5, "DATALOADER.FILTER_EMPTY_ANNOTATIONS", False]
    elif kind == "semantic":
        opts += ["MODEL.META_ARCHITECTURE", "SemanticSegmentor", "INPUT.MIN_SIZE_TRAIN", RETINANET_MIN_SIZES]
    else:
        raise ValueError(f"no dense configuration {kind!r}")
    if narrow:
        opts += ["MODEL.RESNETS.RES2_OUT_CHANNELS", 64, "MODEL.RESNETS.WIDTH_PER_GROUP", 16, "MODEL.FPN.OUT_CHANNELS", 64,
                 "MODEL.RETINANET.NUM_CONVS", 2, "MODEL.RETINANET.NUM_CLASSES", 5,
                 "MODEL.RETINANET.TOPK_CANDIDATES_TEST", 200, "MODEL.SEM_SEG_HEAD.CONVS_DIM", 32,
                 "MODEL.SEM_SEG_HEAD.NUM_CLASSES", 7, "MODEL.ROI_HEADS.NUM_CLASSES", 5, "MODEL.ROI_BOX_HEAD.FC_DIM", 128,
                 "MODEL.ROI_MASK_HEAD.NUM_CONV", 2, "MODEL.ROI_MASK_HEAD.CONV_DIM", 32,
                 "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100,
                 "MODEL.RPN.BATCH_SIZE_PER_IMAGE", 8192, "MODEL.RPN.POSITIVE_FRACTION", 0.999,
                 "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 128, "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.999,
                 "MODEL.RPN.PRE_NMS_TOPK_TEST", 200, "MODEL.RPN.POST_NMS_TOPK_TEST", 100,
                 "TEST.DETECTIONS_PER_IMAGE", 30]
    return opts


def syncbn_opts(narrow: bool = False):
    """detectron2's model zoo Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml on
    Base-RCNN-FPN.yaml, for either package's config: R-50 (STRIDE_IN_1X1),
    MASK_ON, 80 classes, ``NORM "SyncBN"`` in the ResNet, the FPN, a
    FastRCNNConvFCHead box head of 4 convs 256 wide and 1 fc of 1024, and
    the mask head (``ROI_MASK_HEAD.NORM``, which neither package reads),
    and ``TEST.PRECISE_BN.ENABLED``; its 3x schedule and ImageNet weights are
    not taken. ``narrow``: phase 48's and the CPU tests' widths (res2 64,
    FPN 64, 5 classes, the box head 2 convs 32 wide and an fc of 64, the
    mask head 2 convs 32 wide, small top-k sizes, exhaustive sampling)."""
    opts = ["MODEL.RESNETS.DEPTH", 50, "MODEL.MASK_ON", True, "MODEL.ROI_HEADS.NUM_CLASSES", 80,
            "MODEL.RESNETS.NORM", "SyncBN", "MODEL.RESNETS.STRIDE_IN_1X1", True, "MODEL.FPN.NORM", "SyncBN",
            "MODEL.ROI_BOX_HEAD.NAME", "FastRCNNConvFCHead", "MODEL.ROI_BOX_HEAD.NUM_CONV", 4,
            "MODEL.ROI_BOX_HEAD.CONV_DIM", 256, "MODEL.ROI_BOX_HEAD.NUM_FC", 1, "MODEL.ROI_BOX_HEAD.FC_DIM", 1024,
            "MODEL.ROI_BOX_HEAD.NORM", "SyncBN", "MODEL.ROI_MASK_HEAD.NORM", "SyncBN", "TEST.PRECISE_BN.ENABLED", True]
    if narrow:
        opts += ["MODEL.RESNETS.RES2_OUT_CHANNELS", 64, "MODEL.RESNETS.WIDTH_PER_GROUP", 16, "MODEL.FPN.OUT_CHANNELS", 64,
                 "MODEL.ROI_HEADS.NUM_CLASSES", 5, "MODEL.ROI_BOX_HEAD.NUM_CONV", 2, "MODEL.ROI_BOX_HEAD.CONV_DIM", 32,
                 "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.ROI_MASK_HEAD.NUM_CONV", 2, "MODEL.ROI_MASK_HEAD.CONV_DIM", 32,
                 "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100,
                 "MODEL.RPN.BATCH_SIZE_PER_IMAGE", 8192, "MODEL.RPN.POSITIVE_FRACTION", 0.999,
                 "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 128, "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.999,
                 "MODEL.RPN.PRE_NMS_TOPK_TEST", 200, "MODEL.RPN.POST_NMS_TOPK_TEST", 100,
                 "TEST.DETECTIONS_PER_IMAGE", 30]
    return opts


def syncbn_stats(rng, n: int):
    """Seeded SyncBN statistics and affine for ``n`` channels (numpy
    float32): ``running_var`` in (0.5, 2) and ``running_mean`` N(0, 0.1),
    never the init's 1 and 0, so that a swapped or unused statistic shows;
    ``weight`` sqrt(var) times U(0.9, 1.1), so that each norm scales by
    about 1 whatever its variance, and ``bias`` N(0, 0.05)."""
    var = rng.uniform(0.5, 2.0, n).astype("float32")
    return {"running_mean": rng.normal(0, 0.1, n).astype("float32"), "running_var": var,
            "weight": (var ** 0.5 * rng.uniform(0.9, 1.1, n)).astype("float32"),
            "bias": rng.normal(0, 0.05, n).astype("float32")}


def seed_syncbn(model, seed: int = 0):
    """``syncbn_stats`` into every ``SyncBatchNorm`` of the port's ``model``,
    in module order."""
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.layers import SyncBatchNorm

    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SyncBatchNorm):
                for k, v in syncbn_stats(rng, m.num_features).items():
                    getattr(m, k).copy_(torch.from_numpy(v))
    return model


@contextlib.contextmanager
def cli_tf32():
    """TF32 convolutions inside the block, PyTorch's default and the
    training CLIs' setting (the heads run in float32 under bf16 and AMP, as
    flax promotes them), back to off after it."""
    import torch

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def add_launches(kernels, name: str, n: int, timed=None, err=None):
    """Adds a path's launches to ``name``'s entry of the kernels line. A run
    of selected phases without the kernel phases (``--phases``) makes the
    entry from this path's own timed call: (ms, plain_ms, bound_ms,
    bound_by) and its largest error against the plain version."""
    if name not in kernels:
        ms, plain_ms, bound_ms, bound_by = timed
        kernels[name] = dict(name=name, route="cuda", source=KERNEL_SOURCE[name], replaces=KERNEL_REPLACES[name],
                             launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
    kernels[name]["launches"] += n


def p14_calls(rec):
    """A ``PoolRecorder`` holding only ``rec``'s P=14 calls."""
    sub = PoolRecorder()
    sub.band = [c for c in rec.band if c[1].rows.shape[1] == 14]
    sub.fwd = [c for c in rec.fwd if c[1].rows.shape[1] == 14]
    sub.bwd = [c for c in rec.bwd if c[1].rows.shape[1] == 14]
    return sub


def serving_batch(B, H=832, W=1344, seed=0):
    import torch

    g = torch.Generator(device=CARD).manual_seed(seed)
    return {"image": torch.rand(B, H, W, 3, generator=g, device=CARD) * 255,
            "image_size": torch.tensor([[H, W]] * B, dtype=torch.int32, device=CARD)}


def task_serving(kind: str, kernels, tag, B: int = 8):
    """The serving forwards of ``task_cfg(kind)``: bf16, seeded damped
    weights, score threshold 0.001 (so that the random detector keeps
    detections), B=``B`` at 832x1344, with POOLER_IMPL pallas_fast (K1 twice
    a forward: the boxes at P=7, the mask or keypoint boxes at P=14) and then
    auto (K2 twice), 1 warm-up and 3 timed forwards each with every count set
    to 0 just before and read just after; the outputs' shapes and ranges;
    one more forward of each recorded, its P=14 pool held to its plain
    version (``check_recorded_pool``, timed) and all its calls too. Returns
    the last auto forward's output (Panoptic FPN's dict, else its
    detections) and the recorded P=14 times. A SyncBN model's norms get
    ``seed_syncbn``'s statistics on top of the damped weights."""
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.utils.init import damped_init

    batch = serving_batch(B)
    B = len(batch["image"])
    parts, times = [], {}
    for impl, kernel, name in (("pallas_fast", ra.roi_align_band, "roi_align_band"),
                               ("auto", ra.roi_align_paired, "roi_align_paired")):
        cfg = task_cfg(kind, impl)
        cfg.MODEL.DTYPE = "bfloat16"
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.001
        model = seed_syncbn(damped_init(build_model(cfg), seed=0))
        model(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ra.roi_align_band.launches = ra.roi_align_paired.launches = 0
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            dets = model(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n = ra.roi_align_band.launches, ra.roi_align_paired.launches
        if n != ((2 * iters, 0) if impl == "pallas_fast" else (0, 2 * iters)):
            raise AssertionError(f"{kind} serving {impl}: K1/K2 launches {n} over {iters} forwards")
        out = dets
        if kind == "panoptic":
            dets, sem = out["instances"], out["sem_seg"]
            shape = (B, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES) + tuple(batch["image"].shape[1:3])
            if tuple(sem.shape) != shape or sem.dtype != torch.float32 or not torch.isfinite(sem).all():
                raise AssertionError(f"panoptic serving {impl}: sem_seg {tuple(sem.shape)} {sem.dtype}")
        check_detections(dets, B)
        if not dets.valid.any(dim=1).all():
            raise AssertionError(f"{kind} serving {impl}: an image kept no detection")
        if kind in MASK_KINDS:
            m = dets.masks
            if tuple(m.shape) != (B, 100, 28, 28) or m.dtype != torch.float32 or not torch.isfinite(m).all() \
                    or float(m.min()) < 0 or float(m.max()) > 1 or dets.keypoints is not None:
                raise AssertionError(f"{kind} serving {impl}: masks {tuple(m.shape)} {m.dtype} in "
                                     f"[{float(m.min())}, {float(m.max())}]")
            shown = f"masks {tuple(m.shape)} float32 in [{float(m.min()):.4f}, {float(m.max()):.4f}]"
            if kind == "panoptic":
                shown += f", sem_seg logits {tuple(sem.shape)} float32"
        else:
            k = dets.keypoints
            v = dets.valid
            inside = ((k[..., 0] >= dets.boxes[..., None, 0] - 1e-3) & (k[..., 0] <= dets.boxes[..., None, 2] + 1e-3)
                      & (k[..., 1] >= dets.boxes[..., None, 1] - 1e-3) & (k[..., 1] <= dets.boxes[..., None, 3] + 1e-3))
            if tuple(k.shape) != (B, 100, 17, 3) or not torch.isfinite(k).all() or not bool(inside[v].all()) \
                    or float(k[..., 2].min()) <= 0 or float(k[..., 2].max()) > 1 or dets.masks is not None:
                raise AssertionError(f"keypoint serving {impl}: keypoints {tuple(k.shape)} outside their boxes or "
                                     f"scores outside (0, 1]")
            shown = f"keypoints {tuple(k.shape)} inside their boxes, scores in (0, 1]"
        rec = PoolRecorder()
        with rec:
            model(batch)
        shapes = sorted(c[1].rows.shape[1] for c in rec.band + rec.fwd)
        if shapes != [7, 14]:
            raise AssertionError(f"{kind} serving {impl}: recorded pools at P={shapes}")
        what = f"{kind} serving {impl} (B={B}, bf16)"
        check_recorded_pool(f"{what}, all pools", rec, tag)
        sub = p14_calls(rec)
        t = check_recorded_pool(f"{what}, the P=14 pool on the detections' boxes", sub, tag, timed=True)
        key = "K1" if impl == "pallas_fast" else "K2"
        times[key] = t[key]
        add_launches(kernels, name, n[0] + n[1], t[key], sub.max_err[key])
        parts.append(f"{impl} {ms:.2f} ms/batch ({B * 1e3 / ms:.2f} img/s), peak memory {peak:.2f} GiB, K1/K2 "
                     f"{n[0]}/{n[1]}, valid detections {dets.valid.sum(dim=1).tolist()}, {shown}")
        del model
        torch.cuda.empty_cache()
    name = TASK_NAMES[kind]
    print(f"{kind} serving: {name} bf16 B={B} at 832x1344 (TF32 convolutions): " + "; ".join(parts) + f" {tag}")
    return out, times


def mask_serving_path(tag, kernels):
    """Phase 32, Mask R-CNN serving (``task_cfg("mask")``,
    COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml): ``task_serving``
    at B=8, then the evaluator's host work on the last forward's
    detections: each image's valid masks pasted at 832x1344 with
    ``paste_masks_np`` and encoded as RLE rows (``detections_to_coco_json``),
    ms an image."""
    from lvc_tpu_torch.evaluation.coco_evaluation import detections_to_coco_json, host_detections
    from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import index_detections

    with cli_tf32():
        dets, times = task_serving("mask", kernels, tag)
    t0 = time.perf_counter()
    host = host_detections(dets)
    copy_ms = (time.perf_counter() - t0) * 1e3
    B = host.boxes.shape[0]
    rows = []
    t0 = time.perf_counter()
    for i in range(B):
        meta = {"image_id": i + 1, "image_size": (832, 1344), "orig_size": (832, 1344)}
        rows += detections_to_coco_json(index_detections(host, i), meta)
    paste_ms = (time.perf_counter() - t0) * 1e3 / B
    if len(rows) != int(host.valid.sum()) or not all("segmentation" in r for r in rows):
        raise AssertionError("mask serving: result rows without a segmentation")
    print(f"mask serving: the evaluator's host work on the auto forward's detections: copy to the host "
          f"{copy_ms:.1f} ms a batch, paste_masks_np + RLE {paste_ms:.1f} ms an image ({len(rows) / B:.1f} masks an "
          f"image pasted at 832x1344) {tag}")
    return times


def task_train(kind: str, kernels, tag, B: int, amps=(False, True)):
    """Training steps of ``task_cfg(kind, "pallas_train")`` through
    ``make_train_step`` at B=``B`` on 832x1344 (seeded damped weights, a
    seeded batch of 4-16 gts an image with ``box_masks`` at 1/4 of the
    canvas, or ``box_keypoints``), float32 and AMP: a warm-up step, then
    ``TASK_ITERS`` timed steps with every count set to 0 just before and read
    just after (K2 and K3 twice a step: the boxes at P=7, the mask or
    keypoint slots at P=14), the first step's losses (``loss_mask`` near ln 2
    from damped weights), every loss finite, the peak memory; one more AMP
    step recorded, its four pool calls held to their plain versions and the
    P=14 pair timed. ``panoptic`` takes ``dense_batch`` (``sem_seg`` maps
    with 255 in the padding, and gt bitmasks) and adds ``loss_sem_seg``.
    ``amps``: the runs, float32 (False) and AMP (True; the last must be
    AMP). Returns the recorded P=14 times."""
    import torch

    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer
    from lvc_tpu_torch.utils.init import damped_init

    k2, k3 = ra.roi_align_paired, ra.roi_align_paired_bwd
    cfg = task_cfg(kind, "pallas_train")
    classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    if kind == "panoptic":
        batch = dense_batch(B, 832, 1344, 16, seed=0, device=CARD, num_classes=classes,
                            sem_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, n_gt=(4, 16), size=(32, 500))
    else:
        batch = train_batch(B, 832, 1344, 16, seed=0, device=CARD, num_classes=classes, n_gt=(4, 16), size=(32, 500))
    if kind in MASK_KINDS:
        batch.setdefault("gt_masks", box_masks(batch["gt_boxes"], batch["gt_valid"], 832, 1344))
        task_loss = "loss_mask"
    else:
        batch["gt_keypoints"] = box_keypoints(batch["gt_boxes"], batch["gt_valid"], seed=0)
        task_loss = "loss_keypoint"
    B = len(batch["image"])
    parts, launches = [], [0, 0]
    for amp in amps:
        model = damped_init(build_model(cfg), seed=0).train()
        opt = build_optimizer(cfg, model)
        step = make_train_step(model, opt, build_lr_schedule(cfg, opt), mixed_precision=amp)
        gen = torch.Generator(device=CARD).manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        first = {k: float(v) for k, v in step(batch, gen).items()}
        torch.cuda.synchronize()
        k2.launches = k3.launches = 0
        t0 = time.perf_counter()
        metrics = [step(batch, gen) for _ in range(TASK_ITERS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TASK_ITERS
        n = k2.launches, k3.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        last = {k: float(v) for k, v in metrics[-1].items()}
        if n != (2 * TASK_ITERS, 2 * TASK_ITERS):
            raise AssertionError(f"{kind} training: K2/K3 launches {n} over {TASK_ITERS} steps")
        if task_loss not in first or not all(math.isfinite(float(v)) for m in metrics for v in m.values()):
            raise AssertionError(f"{kind} training: {task_loss} missing or a loss not finite: {first}, {last}")
        if kind in MASK_KINDS and abs(first["loss_mask"] - math.log(2)) > 0.05:
            raise AssertionError(f"{kind} training: first loss_mask {first['loss_mask']}, want ln 2 within 0.05")
        sem = ""
        if kind == "panoptic":
            # damped weights: uniform logits, so the pixel CE is ln(classes), times LOSS_WEIGHT
            want = cfg.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT * math.log(cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
            if abs(first.get("loss_sem_seg", math.inf) - want) > 0.05:
                raise AssertionError(f"panoptic training: first loss_sem_seg {first.get('loss_sem_seg')}, want {want}")
            sem = (f", loss_sem_seg {first['loss_sem_seg']:.5f} ({cfg.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT} ln "
                   f"{cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES} = {want:.5f}) to {last['loss_sem_seg']:.5f}")
        launches = [a + b for a, b in zip(launches, n)]
        parts.append(f"{'AMP' if amp else 'float32'} {ms:.2f} ms/iter ({B * 1e3 / ms:.2f} img/s), K2/K3 {n[0]}/{n[1]}, "
                     f"peak memory {peak:.2f} GiB, first step {task_loss} {first[task_loss]:.5f} (total "
                     f"{first['total_loss']:.4f}), last step {task_loss} {last[task_loss]:.5f}{sem}")
        if amp:
            rec = PoolRecorder()
            with rec:
                step(batch, gen)
        del model, opt, step
        torch.cuda.empty_cache()
    name = TASK_NAMES[kind]
    print(f"{kind} training: {name} POOLER_IMPL pallas_train B={B} at 832x1344 (TF32 convolutions), "
          f"{TASK_ITERS} timed steps each: " + "; ".join(parts) + f" {tag}")
    if sorted(c[1].rows.shape[1] for c in rec.fwd) != [7, 14] or len(rec.bwd) != 2:
        raise AssertionError(f"{kind} training: recorded {len(rec.fwd)}/{len(rec.bwd)} K2/K3 calls")
    what = f"{kind} AMP step (B={B}, {B} x 512 slots)"
    check_recorded_pool(f"{what}, all pools", rec, tag)
    sub = p14_calls(rec)
    times = check_recorded_pool(f"{what}, the P=14 pool", sub, tag, timed=True)
    for key, name, n in (("K2", "roi_align_paired", launches[0]), ("K3", "roi_align_paired_bwd", launches[1])):
        add_launches(kernels, name, n, times[key], sub.max_err[key])
    return times


def mask_train_path(tag, kernels):
    """Phase 33, the Mask R-CNN training step (``task_train("mask")``) at
    IMS_PER_BATCH 16: the model zoo config's batch on one card."""
    with cli_tf32():
        return task_train("mask", kernels, tag, B=16)


def keypoint_path(tag, kernels):
    """Phase 34, Keypoint R-CNN (``task_cfg("keypoint")``,
    COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml): ``task_serving`` and
    ``task_train`` at B=8, with ``box_keypoints`` (B, G, 17, 3)."""
    with cli_tf32():
        _, serving = task_serving("keypoint", kernels, tag)
        return serving, task_train("keypoint", kernels, tag, B=8)


def task_reference_cfg(kind: str, device: str):
    """Phase 35's narrow models: phase 25's narrow R-50-FPN (exhaustive
    sampling, float32, POOLER_IMPL pallas_train, 5 classes) with the mask
    or the keypoint head 2 convs 32 wide (``narrow_task_heads``); phase
    48's ``syncbn``: the mask model with ``syncbn_opts(narrow=True)``'s
    SyncBN norms and box head."""
    cfg = extra_heads_cfg("StandardROIHeads", device)
    cfg.DEBUG = False
    if kind == "syncbn":
        cfg.merge_from_list(syncbn_opts(narrow=True))
    return narrow_task_heads(cfg, mask=kind in ("mask", "syncbn"), keypoint=kind == "keypoint")


@contextlib.contextmanager
def relu_decisions(model, record=None, follow=None):
    """Forward hooks on the inputs of the mask and keypoint heads' ReLUs
    (their 3x3 convs and the mask head's transposed conv). ``record``: a
    dict that gets each call's decisions (pre-activation > 0) on the CPU, by
    module and in call order. ``follow``: such a dict from another run,
    whose decision this run takes where its own sign differs: the
    pre-activation there (within rounding of 0) is negated in value only, so
    the run's value moves by twice it and its gradient passes as the other
    run's did. A ReLU at its kink routes the gradient by the sign of a
    rounding error, so two correct float32 runs may route it differently;
    ``follow["flips"]`` counts the decisions taken over."""
    import torch

    names = [n for n, m in model.named_modules() if n.rsplit(".", 1)[-1].startswith(("mask_fcn", "conv_fcn"))
             or n.endswith("mask_head.deconv")]
    modules = dict(model.named_modules())
    calls = {n: 0 for n in names}

    def hook(name):
        def fn(module, args, out):
            i = calls[name]
            calls[name] += 1
            if record is not None:
                record.setdefault(name, []).append((out > 0).cpu())
            if follow is None:
                return None
            want = follow[name][i].to(out.device)
            flip = want != (out > 0)
            follow["flips"] = follow.get("flips", 0) + int(flip.sum())
            return out + torch.where(flip, -2 * out + torch.where(want, 1e-30, 0.0), 0.0).detach()
        return fn

    handles = [modules[n].register_forward_hook(hook(n)) for n in names]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def witness_lines(kind, losses, grads):
    """Phases 35 and 39: a training step's losses and trainable gradients on
    the CPU and the card, each held to its own float64 witness (``losses``
    and ``grads``: (the CPU's witness, the CPU's, the card's witness, the
    card's)) within ``witness_limit`` of the CPU's distance. A gradient that
    is 0 in float64 (rounding on every device) must stay below 1e-6 of the
    largest. Returns the report's parts; raises on the first one over."""
    (w_loss, c_loss, v_loss, g_loss), (w_grad, c_grad, v_grad, g_grad) = losses, grads
    lines = []
    for what, want, c, card_want, g in (("loss", w_loss, c_loss, v_loss, g_loss),
                                        ("grad", w_grad, c_grad, v_grad, g_grad)):
        if what == "loss":
            rel = lambda a, w: abs(a - w) / max(abs(w), 1e-30)  # noqa: E731
        else:
            rel = lambda a, w: float((a - w).norm() / w.norm().clamp(min=1e-30))  # noqa: E731
        keys = list(want)
        if what == "grad":
            # a gradient that is 0 in exact arithmetic (the keypoint head's last bias: a softmax over the
            # upsampled cells ignores a constant) is rounding on every device: held below 1e-6 of the largest
            top = max(float(w.norm()) for w in want.values())
            keys = [k for k in want if float(want[k].norm()) > 1e-9 * top]
            if any(float(g[k].norm()) > 1e-6 * top for k in want if k not in keys):
                raise AssertionError(f"{kind} reference: a gradient that is 0 in float64 is not 0 on the card")
        c_err = {k: rel(c[k], want[k]) for k in keys}
        g_err = {k: rel(g[k], card_want[k]) for k in keys}
        over = [k for k in keys if g_err[k] > witness_limit(what, c_err[k])]
        if over:
            k = over[0]
            raise AssertionError(f"{kind} reference: card {what} {k} {g_err[k]:.3e} from float64, the CPU's "
                                 f"{c_err[k]:.3e} (limit {witness_limit(what, c_err[k]):.3e})")
        worst = max(g_err, key=g_err.get)
        # for the record: the card against the witness of the CPU's ReLU decisions
        routed = max(rel(g[k], want[k]) for k in keys)
        lines.append(f"{len(keys)} {what}{'es' if what == 'loss' else 's'} card max {g_err[worst]:.3e} ({worst}; "
                     f"CPU {c_err[worst]:.3e}; the card against the CPU's witness {routed:.3e})")
    return lines


def task_reference_check(tag, kinds=("mask", "keypoint")):
    """Phase 35a (and 48, ``kinds`` ("syncbn",): its norms' statistics and
    affines from ``seed_syncbn``): the narrow Mask R-CNN and Keypoint R-CNN
    (``task_reference_cfg``) at float32 on the card and on the CPU from the
    same weights (``calibrated_init``), both held against a float64 witness
    on the CPU as phase 25 holds its heads (``witness_limit``): one training
    step (its losses, ``loss_mask`` or ``loss_keypoint`` included, and every
    trainable gradient), then the eval forward's detections, masks (abs) and
    keypoints (px, and their scores). Each float32 run has its own witness,
    which takes that run's decisions at the heads' ReLUs
    (``relu_decisions``; the count is printed). K2/K3 2/2 a step and K1/K2
    0/2 an eval forward on the card. Returns the mask model's card and CPU
    detections and its batch, for ``segm_eval_check``."""
    import copy

    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model

    batch = train_batch(2, 128, 192, 4, seed=3, device="cpu", num_classes=5, n_gt=(3, 3), size=(24, 100))
    batch["gt_masks"] = box_masks(batch["gt_boxes"], batch["gt_valid"], 128, 192)
    batch["gt_keypoints"] = box_keypoints(batch["gt_boxes"], batch["gt_valid"], seed=3)
    out = None
    for kind in kinds:
        cfg = task_reference_cfg(kind, "cpu")
        cpu = build_model(cfg, device="cpu")
        calibrated_init(cpu, seed=0)
        seed_syncbn(cpu)
        with torch.no_grad():  # toward detectron2's N(0, 0.001) mask predictor: mask logits O(1)
            for name, t in cpu.state_dict().items():
                if name.startswith("roi_heads.mask_head.predictor."):
                    t.mul_(0.05)
        witness = copy.deepcopy(cpu).double()
        witness.compute_dtype = torch.float64
        gpu_cfg = cfg.clone()
        gpu_cfg.MODEL.DEVICE = CARD
        gpu = build_model(gpu_cfg, device=CARD)
        gpu.load_state_dict(cpu.state_dict())
        res, flips = {}, {}
        for key, model in (("cpu", cpu), ("gpu", gpu)):
            decided = {}
            with relu_decisions(model, record=decided):
                res[key] = extra_heads_run(model, cfg, batch, True)
            with relu_decisions(witness, follow=decided):
                res["f64 " + key] = extra_heads_run(witness, cfg, batch, True)
            flips[key] = decided.get("flips", 0)
        (c_loss, c_grad, c_dets, _, _), (g_loss, g_grad, g_dets, g_step, g_eval) = res["cpu"], res["gpu"]
        # each run against its own witness; the CPU's witness is the reference of the detections
        (w_loss, w_grad, w_dets, _, _), (v_loss, v_grad, _, _, _) = res["f64 cpu"], res["f64 gpu"]
        task_loss = "loss_keypoint" if kind == "keypoint" else "loss_mask"
        if (g_step, g_eval) != ((2, 2), (0, 2)) or task_loss not in g_loss or set(c_loss) != set(g_loss) \
                or set(c_grad) != set(g_grad):
            raise AssertionError(f"{kind} reference: card launches {g_step}/{g_eval} or losses {sorted(g_loss)}")
        lines = witness_lines(kind, (w_loss, c_loss, v_loss, g_loss), (w_grad, c_grad, v_grad, g_grad))
        n, c_box, c_score = detection_errors(f"{kind} CPU vs float64", w_dets, c_dets)
        _, g_box, g_score = detection_errors(f"{kind} card vs float64", w_dets, g_dets)
        v = w_dets.valid
        if kind != "keypoint":
            field, want_t = "masks", w_dets.masks[v]
            c_task, g_task = [float((d.masks[v].double() - want_t).abs().max()) for d in (c_dets, g_dets)]
            limit = witness_limit("score", c_task)
        else:
            # a heatmap whose two best cells tie within float32 rounding may take either on either device: the
            # point moves by whole cells of its box (56ths) and keeps its score; the others are held as boxes are
            field, want_t = "keypoints", w_dets.keypoints[v]
            box = w_dets.boxes[v].double()
            cell = torch.stack([box[:, 2] - box[:, 0], box[:, 3] - box[:, 1]], -1)[:, None, :] / 56
            errs, moved, scores = [], [], []
            for d in (c_dets, g_dets):
                err = (d.keypoints[v][..., :2].double() - want_t[..., :2]).abs()
                tie = (err - cell * torch.round(err / cell)).abs() <= 1e-3
                errs.append(float(torch.where(tie, torch.zeros_like(err), err).max()))
                moved.append(int((tie & (err > 1e-3)).any(-1).sum()))
                scores.append(float((d.keypoints[v][..., 2].double() - want_t[..., 2]).abs().max()))
            if max(moved) > 0.01 * want_t.shape[0] * want_t.shape[1] or scores[1] > witness_limit("score", scores[0]):
                raise AssertionError(f"keypoint reference: {moved} keypoints (CPU, card) whole cells away, scores "
                                     f"{scores} from float64")
            c_task, g_task = errs
            limit = witness_limit("box", c_task)
            field += (f" (whole cells away from float64 where two cells tie: card {moved[1]}, CPU {moved[0]}; "
                      f"scores card {scores[1]:.3e} CPU {scores[0]:.3e})")
        if g_box > witness_limit("box", c_box) or g_score > witness_limit("score", c_score) or g_task > limit:
            raise AssertionError(f"{kind} reference: card boxes {g_box:.3e} scores {g_score:.3e} {field} "
                                 f"{g_task:.3e} from float64; CPU {c_box:.3e} {c_score:.3e} {c_task:.3e}")
        print(f"{kind} reference (card and CPU float32 against CPU float64, narrow): {task_loss} card "
              f"{g_loss[task_loss]:.6f} float64 {w_loss[task_loss]:.6f}; " + "; ".join(lines) + f"; eval {n} valid, "
              f"boxes card {g_box:.3e} px CPU {c_box:.3e}, scores card {g_score:.3e} CPU {c_score:.3e}, {field} card "
              f"{g_task:.3e} CPU {c_task:.3e} (limit {limit:.3e}); ReLU decisions the witnesses took over from "
              f"the card's run {flips['gpu']}, the CPU's {flips['cpu']}; K2/K3 a step {g_step[0]}/{g_step[1]}, K1/K2 "
              f"an eval {g_eval[0]}/{g_eval[1]} {tag}")
        if kind == "mask":
            out = g_dets, c_dets, batch
    return out


def write_segm_json(path: str, n_img: int = 12, hw=(480, 640), seed: int = 0):
    """A seeded COCO ground truth of ``n_img`` images over 3 categories
    whose segmentations mix polygons (some in two parts), uncompressed and
    compressed RLE and crowd regions (RLE), objects 24-200 px. Returns
    (dataset dict, each annotation's bitmask by id)."""
    import json

    import numpy as np

    from lvc_tpu_torch.structures.masks import bitmask_to_rle, polygons_to_bitmask

    rng = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] + 0.5
    images = [{"id": i + 1, "file_name": f"{i}.jpg", "height": h, "width": w} for i in range(n_img)]
    anns, bits = [], {}
    for img in images:
        for k in range(rng.randint(3, 8)):
            bw, bh = rng.uniform(24, 200, 2)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            kind = ("polygon", "rle", "string", "crowd", "parts")[(img["id"] + k) % 5]
            if kind in ("polygon", "parts"):
                t = np.sort(rng.uniform(0, 2 * np.pi, 9))
                r = rng.uniform(0.7, 1.0, 9)
                pts = np.stack([x0 + bw / 2 * (1 + r * np.cos(t)), y0 + bh / 2 * (1 + r * np.sin(t))], -1)
                seg = [pts.reshape(-1).round(2).tolist()]
                if kind == "parts":
                    seg.append([x0, y0, x0 + bw / 4, y0, x0, y0 + bh / 4])
                m = polygons_to_bitmask(seg, h, w)
            else:
                m = ((yy - y0 - bh / 2) / (bh / 2)) ** 2 + ((xx - x0 - bw / 2) / (bw / 2)) ** 2 <= 1
                seg = bitmask_to_rle(m)
                if kind == "string":
                    seg = dict(seg, counts=rle_string(seg["counts"]))
            ys, xs = np.nonzero(m)
            ann = {"id": len(anns) + 1, "image_id": img["id"], "category_id": int(rng.choice([1, 2, 3])),
                   "segmentation": seg, "area": float(m.sum()), "iscrowd": int(kind == "crowd"),
                   "bbox": [float(xs.min()), float(ys.min()), float(xs.max() + 1 - xs.min()),
                            float(ys.max() + 1 - ys.min())]}
            anns.append(ann)
            bits[ann["id"]] = m
    dataset = {"images": images, "annotations": anns,
               "categories": [{"id": c, "name": f"shape{c}"} for c in (1, 2, 3)]}
    with open(path, "w") as f:
        json.dump(dataset, f)
    return dataset, bits


def rle_string(counts) -> str:
    """The COCO mask API's compressed form of run-length counts (its
    ``rleToString``)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            out.append(chr((c | (0x20 if more else 0)) + 48))
    return "".join(out)


def oracle_detections(dataset, bits, device, shift: float = 0.0, scale: float = 1.25, D: int = 16):
    """Padded ``Detections`` of a ``write_segm_json`` tree on a canvas
    ``scale`` times the images, on ``device``, and their metas: each non-crowd
    gt's bitmask cropped to 28 x 28 over its box by the port's
    ``crop_gt_masks``, the detection's box that box moved ``shift`` px right
    and down (so the mask lands moved)."""
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections
    from lvc_tpu_torch.modeling.roi_heads.mask_head import crop_gt_masks

    images = dataset["images"]
    B = len(images)
    boxes = torch.zeros(B, D, 4, device=device)
    masks = torch.zeros(B, D, 28, 28, device=device)
    classes = torch.zeros(B, D, dtype=torch.int64, device=device)
    valid = torch.zeros(B, D, dtype=torch.bool, device=device)
    for i, img in enumerate(images):
        anns = [a for a in dataset["annotations"] if a["image_id"] == img["id"] and not a["iscrowd"]][:D]
        if not anns:
            continue
        x, y, w, h = (torch.tensor([a["bbox"] for a in anns], dtype=torch.float32, device=device).T)
        box = torch.stack([x, y, x + w, y + h], -1)
        gt = torch.from_numpy(np.stack([bits[a["id"]] for a in anns])).to(device)
        n = len(anns)
        masks[i, :n] = crop_gt_masks(gt, box, torch.arange(n, device=device), 28)
        boxes[i, :n] = (box + shift) * scale
        classes[i, :n] = torch.tensor([a["category_id"] - 1 for a in anns], device=device)
        valid[i, :n] = True
    scores = torch.linspace(0.9, 0.5, D, device=device).expand(B, D).contiguous()
    dets = Detections(boxes, scores, classes, valid, torch.zeros_like(classes), masks=masks)
    h, w = images[0]["height"], images[0]["width"]
    metas = [{"image_id": img["id"], "image_size": (round(h * scale), round(w * scale)), "orig_size": (h, w)}
             for img in images]
    return dets, metas


def segm_eval_check(tag, narrow):
    """Phase 35b: segm evaluation through ``COCOEvaluator`` (registered on a
    ``write_segm_json`` tree of 12 images at 480x640 with polygon, RLE and
    crowd ground truth) from the card's tensors: oracle detections (each gt
    mask cropped to 28 x 28 by ``crop_gt_masks`` on the card, on a 1.25x
    canvas; the evaluator pastes them back at 480x640) must reach
    ``MASK_AP_FLOOR`` segm AP; the same masks moved 3 px must score inside
    ``SHIFTED_AP``; ms an image of the evaluator's host work. Then the
    narrow mask model's card and CPU eval detections (phase 35a) as RLE rows
    (``detections_to_coco_json`` at the 128x192 canvas): on every valid slot
    the card's mask against the CPU's, RLE IoU at least ``MASK_ROW_IOU``."""
    import os
    import tempfile

    import numpy as np

    from lvc_tpu_torch.data.catalog import MetadataCatalog
    from lvc_tpu_torch.evaluation.coco_evaluation import COCOEvaluator, detections_to_coco_json, host_detections
    from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import index_detections
    from lvc_tpu_torch.structures.masks import rle_to_bitmask

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "segm.json")
        dataset, bits = write_segm_json(path)
        kinds = {("poly" if isinstance(a["segmentation"], list) else "rle") + ("-crowd" if a["iscrowd"] else "")
                 for a in dataset["annotations"]}
        MetadataCatalog.get("segmcheck_test").set(json_file=path, thing_classes=["shape1", "shape2", "shape3"],
                                                  thing_dataset_id_to_contiguous_id={1: 0, 2: 1, 3: 2})
        results = {}
        for shift in (0.0, 3.0):
            dets, metas = oracle_detections(dataset, bits, CARD, shift)
            ev = COCOEvaluator("segmcheck_test")
            t0 = time.perf_counter()
            ev.process_detections(dets, metas)
            host_ms = (time.perf_counter() - t0) * 1e3 / len(metas)
            results[shift] = ev.evaluate(), host_ms, len(ev._predictions)
    (exact, host_ms, n_rows), (moved, _, _) = results[0.0], results[3.0]
    ap, ap_moved = exact["segm"]["AP"], moved["segm"]["AP"]
    if not ap >= MASK_AP_FLOOR or not SHIFTED_AP[0] < ap_moved < SHIFTED_AP[1]:
        raise AssertionError(f"segm evaluation: oracle AP {ap} (floor {MASK_AP_FLOOR}), moved 3 px {ap_moved} "
                             f"(want inside {SHIFTED_AP})")
    print(f"segm evaluation ({len(dataset['annotations'])} gts: {sorted(kinds)}; {n_rows} oracle rows from the card's "
          f"crop_gt_masks): segm AP {ap:.4f} AP50 {exact['segm']['AP50']:.4f} AP75 {exact['segm']['AP75']:.4f} "
          f"(floor {MASK_AP_FLOOR}), bbox AP {exact['bbox']['AP']:.4f}; moved 3 px segm AP {ap_moved:.4f} (want "
          f"inside {SHIFTED_AP}); evaluator host work {host_ms:.1f} ms an image {tag}")

    g_dets, c_dets, batch = narrow
    rows = {}
    for key, dets in (("card", g_dets), ("cpu", c_dets)):
        host = host_detections(dets)
        rows[key] = [detections_to_coco_json(index_detections(host, i), {"image_id": i + 1, "image_size": (128, 192),
                                                                         "orig_size": (128, 192)})
                     for i in range(host.boxes.shape[0])]
    ious = []
    for card_rows, cpu_rows in zip(rows["card"], rows["cpu"]):
        if len(card_rows) != len(cpu_rows):
            raise AssertionError("narrow mask model: the card's and the CPU's valid slots differ")
        for a, b in zip(card_rows, cpu_rows):
            ma, mb = rle_to_bitmask(a["segmentation"]), rle_to_bitmask(b["segmentation"])
            union = int((ma | mb).sum())
            ious.append(int((ma & mb).sum()) / union if union else 1.0)
    if not ious or min(ious) < MASK_ROW_IOU:
        raise AssertionError(f"narrow mask model: card rows' masks against the CPU's, min RLE IoU "
                             f"{min(ious) if ious else None} (want >= {MASK_ROW_IOU})")
    print(f"segm rows of the narrow mask model: {len(ious)} card rows against the CPU's, RLE IoU min "
          f"{min(ious):.6f} mean {float(np.mean(ious)):.6f} (want >= {MASK_ROW_IOU}) {tag}")


def task_heads_phase(tag):
    """Phase 35: ``task_reference_check`` then ``segm_eval_check``."""
    segm_eval_check(tag, task_reference_check(tag))


# ---------------------------------------------------------------------------
# RetinaNet, the semantic FPN and Panoptic FPN, their evaluators (phases 36-39)
# ---------------------------------------------------------------------------

CITYSCAPES_SHIFTED_AP = (75.0, 95.0)  # phase 39: the oracle boxes moved 3 px right and down, box AP inside this range


def prior_focal_loss(p: float, alpha: float, gamma: float, K: int, n_pos: int, n_valid: int) -> float:
    """``loss_cls`` of a RetinaNet whose every score is ``p``: each
    non-ignored anchor adds K focal terms (one positive term for a
    foreground anchor's class), divided by the positive count."""
    pos = alpha * (1 - p) ** gamma * -math.log(p)
    neg = (1 - alpha) * p ** gamma * -math.log(1 - p)
    return (n_pos * (pos + (K - 1) * neg) + (n_valid - n_pos) * K * neg) / max(n_pos, 1)


def prior_model(cfg, seed: int = 0):
    """``build_model(cfg)`` with seeded damped weights, RetinaNet's head
    initialised as its module is (N(0, 0.01), every score at the prior)."""
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.utils.init import damped_init

    model = damped_init(build_model(cfg), seed=seed)
    if hasattr(model, "head"):
        model.head.init_weights(torch.Generator(device=model.device).manual_seed(seed))
    return model


def retinanet_serving(tag, B: int = 8):
    """Phase 36a: RetinaNet (``task_cfg("retinanet")``) serving in bf16 at
    B=8 on 832x1344 from ``prior_model`` weights, at the yaml's
    SCORE_THRESH_TEST 0.05 and at 0: 1 warm-up and 3 timed forwards each.
    At seeded init every score sits at the prior 0.01, so 0.05 must keep
    nothing; at 0 each level's 1,000 best candidates (5,000 an image) must
    reach the class-aware NMS (recorded on one more forward) and every image
    keep detections. No TPU kernel runs here (K1/K2/K3 0)."""
    import torch

    from lvc_tpu_torch.modeling.meta_arch import retinanet as rn
    from lvc_tpu_torch.ops import roi_align as ra

    cfg = task_cfg("retinanet")
    cfg.MODEL.DTYPE = "bfloat16"
    model = prior_model(cfg)
    batch = serving_batch(B)
    B, r = len(batch["image"]), cfg.MODEL.RETINANET
    with torch.no_grad():
        _, logits, _ = model.head_outputs(model.backbone(model.model_images(batch)))
        top = max(float(torch.sigmoid(x).max()) for x in logits)
        anchors = sum(x.shape[1] for x in logits)
        reach = sum(min(r.TOPK_CANDIDATES_TEST, x.shape[1] * x.shape[2]) for x in logits)
    parts = []
    for thresh in (r.SCORE_THRESH_TEST, 0.0):
        model.score_thresh_test = thresh
        model(batch)
        torch.cuda.synchronize()
        ra.roi_align_band.launches = ra.roi_align_paired.launches = ra.roi_align_paired_bwd.launches = 0
        t0 = time.perf_counter()
        for _ in range(3):
            dets = model(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        seen, nms = [], rn.batched_nms_mask
        rn.batched_nms_mask = lambda boxes, scores, idxs, valid, thr: seen.append(valid.sum(1).tolist()) or nms(
            boxes, scores, idxs, valid, thr)
        try:
            model(batch)
        finally:
            rn.batched_nms_mask = nms
        n = (ra.roi_align_band.launches, ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches)
        check_detections(dets, B)
        kept = dets.valid.sum(1).tolist()
        cands = [reach] * B if thresh == 0 else [0] * B
        if (any(kept) if thresh > 0 else not all(kept)) or seen[0] != cands or n != (0, 0, 0):
            raise AssertionError(f"retinanet serving at {thresh}: kept {kept}, NMS candidates {seen}, K1/K2/K3 {n}")
        parts.append(f"SCORE_THRESH_TEST {thresh}{' (the yaml)' if thresh > 0 else ''}: {ms:.2f} ms/batch "
                     f"({B * 1e3 / ms:.2f} img/s), NMS candidates an image {seen[0][0]}, detections kept {kept}")
    print(f"retinanet serving: RetinaNet R-50-FPN (9 anchors, {anchors:,} an image) bf16 B={B} at 832x1344, prior "
          f"init (largest score {top:.5f}): " + "; ".join(parts) + f"; K1/K2/K3 0/0/0 {tag}")


def retinanet_train_net(tag, root: str):
    """Phase 36b: RetinaNet through ``train_net.main`` in this process
    (``dense_opts("retinanet")`` on Base-RCNN-FPN.yaml: IMS_PER_BATCH 16,
    the yaml's train sizes on the 832x1344 canvas, AMP, BASE_LR 0.01) from
    a ``prior_model`` ``.pth``, ``TASK_ITERS`` iterations on phase 17's
    seeded COCO tree (``coco_trainval_base``: its images hold the 60 base
    classes, so NUM_CLASSES is 60 here; the "all" splits would take the LVC
    few-shot merge), then its COCO evaluation on ``coco_test_base`` at
    SCORE_THRESH_TEST 0 (the scores sit near the prior). The first step's ``loss_cls`` is held within 2% of the
    focal loss the prior predicts for that batch's labels (recorded from
    ``RetinaNet.label_anchors``; the prior 0.01 as bf16 logits make it);
    ms/iter, data_time and peak memory as phase 17 reports them; no TPU
    kernel launches."""
    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.modeling.meta_arch.retinanet import RetinaNet
    from lvc_tpu_torch.tools import train_net

    cfg = task_cfg("retinanet")
    cfg.MODEL.RETINANET.NUM_CLASSES = 60
    r = cfg.MODEL.RETINANET
    with tempfile.TemporaryDirectory() as tmp:
        model = prior_model(cfg)
        weights = DetectionCheckpointer(model, os.path.join(tmp, "weights")).save("prior_init", iteration=0)
        del model
        counts, label = [], RetinaNet.label_anchors

        def recording(self, *args):
            cls, matched = label(self, *args)
            counts.append((int(((cls >= 0) & (cls < self.num_classes)).sum()), int((cls >= 0).sum())))
            return cls, matched

        opts = [str(x) for x in dense_opts("retinanet")] + [
            "MODEL.WEIGHTS", weights, "SOLVER.IMS_PER_BATCH", "16", "SOLVER.MAX_ITER", str(TASK_ITERS),
            "SOLVER.AMP.ENABLED", "True", "DATASETS.TRAIN", "('coco_trainval_base',)", "MODEL.RETINANET.NUM_CLASSES",
            "60", "DATASETS.TEST", "('coco_test_base',)", "MODEL.RETINANET.SCORE_THRESH_TEST", "0.0", "SEED", "0",
            "OUTPUT_DIR", os.path.join(tmp, "out")]
        torch.cuda.reset_peak_memory_stats()
        RetinaNet.label_anchors = recording
        try:
            res, secs, n, trainer = run_cli(train_net, ["--config-file", BASE_YAML] + opts)
        finally:
            RetinaNet.label_anchors = label
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = trainer.storage.histories()
    first, last = hist["loss_cls"].values()[0], hist["loss_cls"].values()[-1]
    p = float(torch.sigmoid(torch.tensor(-math.log((1 - r.PRIOR_PROB) / r.PRIOR_PROB)).bfloat16().float()))
    want = prior_focal_loss(p, r.FOCAL_LOSS_ALPHA, r.FOCAL_LOSS_GAMMA, r.NUM_CLASSES, *counts[0])
    ap = res["bbox"]["AP"]
    if trainer.cfg.MODEL.META_ARCHITECTURE != "RetinaNet" or len(trainer.step_s) != TASK_ITERS or n != (0, 0, 0) \
            or abs(first - want) > 0.02 * want or not math.isfinite(ap) or len(counts) != TASK_ITERS:
        raise AssertionError(f"retinanet train_net: {len(trainer.step_s)} steps, K1/K2/K3 {n}, first loss_cls "
                             f"{first} (the prior predicts {want}), AP {ap}")
    train_net_report(f"retinanet train_net: RetinaNet R-50-FPN 60 classes AMP, IMS_PER_BATCH 16 at 832x1344 (TF32 "
                     f"convolutions)", trainer, secs, peak, 16, tag)
    print(f"retinanet train_net: first step loss_cls {first:.5f}, the prior's focal loss {want:.5f} ({counts[0][0]} "
          f"positive of {counts[0][1]:,} non-ignored anchors, p = {p:.6f}: 0.01 as bf16 logits), step "
          f"{TASK_ITERS} {last:.5f}; evaluation of coco_test_base at score threshold 0: bbox AP {ap:.4f}, "
          f"{trainer.test_s * 1e3 / TRAIN_NET_TREE[1]:.1f} ms/img; K1/K2/K3 0/0/0 {tag}")


def retinanet_path(tag, root: str):
    """Phase 36: ``retinanet_serving`` and ``retinanet_train_net``."""
    with cli_tf32():
        retinanet_serving(tag)
        retinanet_train_net(tag, root)


def panoptic_path(tag, kernels):
    """Phase 37, Panoptic FPN (``task_cfg("panoptic")``,
    COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml): ``task_serving``
    at B=8 (K1 twice a forward with pallas_fast, K2 twice with auto, each
    held to its plain version on the forward's tensors), then on the host
    for each image of the auto forward: ``paste_masks_np`` at 832x1344,
    ``combine_semantic_and_instance_outputs`` with the config's thresholds
    but INSTANCES_CONFIDENCE_THRESH 0 (the random detector's scores sit near
    1/81) and PQ of the result against itself (100); then
    ``task_train`` at IMS_PER_BATCH 16, AMP only (``dense_batch``: sem_seg
    maps with 255 in the padding, gt bitmasks), K2/K3 twice a step."""
    import numpy as np

    from lvc_tpu_torch.evaluation.coco_evaluation import host_detections
    from lvc_tpu_torch.evaluation.panoptic_evaluation import COCOPanopticEvaluator
    from lvc_tpu_torch.modeling.meta_arch.panoptic_fpn import combine_semantic_and_instance_outputs
    from lvc_tpu_torch.structures.masks import paste_masks_np

    combine = task_cfg("panoptic").MODEL.PANOPTIC_FPN.COMBINE
    with cli_tf32():
        out, serving = task_serving("panoptic", kernels, tag)
        host = host_detections(out["instances"])
        B = host.boxes.shape[0]
        ev = COCOPanopticEvaluator()
        things = stuff = 0
        t0 = time.perf_counter()
        for i in range(B):
            v = host.valid[i]
            masks = paste_masks_np(host.masks[i][v], host.boxes[i][v], tuple(out["sem_seg"].shape[2:]))
            logits = out["sem_seg"][i].permute(1, 2, 0).cpu().numpy()
            pan, segments = combine_semantic_and_instance_outputs(
                host.boxes[i][v], host.scores[i][v], host.classes[i][v], np.ones(int(v.sum()), bool), masks, logits,
                combine.OVERLAP_THRESH, combine.STUFF_AREA_LIMIT, 0.0)
            ev.process(pan, segments, pan, segments)
            things += sum(s["isthing"] for s in segments)
            stuff += sum(not s["isthing"] for s in segments)
        host_ms = (time.perf_counter() - t0) * 1e3 / B
        pq = ev.evaluate()["panoptic_seg"]["PQ"]
        if pq != 100.0 or not things or not stuff:
            raise AssertionError(f"panoptic combine: PQ against itself {pq}, {things} thing and {stuff} stuff segments")
        print(f"panoptic combine on the host: paste_masks_np at 832x1344 + the logits' copy + "
              f"combine_semantic_and_instance_outputs {host_ms:.1f} ms an image; {things / B:.1f} thing and "
              f"{stuff / B:.1f} stuff segments an image; PQ of the combine against itself {pq:.1f} {tag}")
        return serving, task_train("panoptic", kernels, tag, B=16, amps=(True,))


def semantic_path(tag):
    """Phase 38, the semantic FPN (``task_cfg("semantic")``,
    Misc/semantic_R_50_FPN_1x.yaml): bf16 serving at B=8 on 832x1344 (1
    warm-up and 3 timed forwards; logits (8, 54, 832, 1344) float32), then
    ``make_train_step`` with AMP at B=16 (``dense_batch``): a warm-up step
    and ``TASK_ITERS`` timed, the first ``loss_sem_seg`` ln 54 within 0.05
    from damped weights, peak memory; then the trained model's predictions
    on its training batch (argmax on the card) through ``SemSegEvaluator``
    (54 classes, 255 ignored): mIoU, pACC. No TPU kernel runs."""
    import numpy as np
    import torch

    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.evaluation.sem_seg_evaluation import SemSegEvaluator
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer

    with cli_tf32():
        cfg = task_cfg("semantic")
        C = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        serve = cfg.clone()
        serve.MODEL.DTYPE = "bfloat16"
        model = prior_model(serve)
        batch = serving_batch(8)
        model(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            logits = model(batch)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3 / 3
        serve_batch = len(batch["image"])
        if tuple(logits.shape) != (serve_batch, C) + tuple(batch["image"].shape[1:3]) \
                or logits.dtype != torch.float32 or not torch.isfinite(logits).all():
            raise AssertionError(f"semantic serving: logits {tuple(logits.shape)} {logits.dtype}")
        del model, logits
        torch.cuda.empty_cache()

        batch = dense_batch(16, 832, 1344, 16, seed=0, device=CARD, sem_classes=C)
        model = prior_model(cfg).train()
        opt = build_optimizer(cfg, model)
        step = make_train_step(model, opt, build_lr_schedule(cfg, opt), mixed_precision=True)
        torch.cuda.reset_peak_memory_stats()
        first = float(step(batch)["loss_sem_seg"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = [step(batch) for _ in range(TASK_ITERS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TASK_ITERS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        last = float(metrics[-1]["loss_sem_seg"])
        if abs(first - math.log(C)) > 0.05 or not all(math.isfinite(float(m["total_loss"])) for m in metrics):
            raise AssertionError(f"semantic training: first loss_sem_seg {first} (ln {C} = {math.log(C)}), last {last}")
        model.eval()
        with torch.no_grad():
            pred = model(batch).argmax(1).cpu().numpy()
        gt = batch["sem_seg"].cpu().numpy()
        ev = SemSegEvaluator("seeded", num_classes=C)
        for p, g in zip(pred, gt):
            ev.process(p, g)
        res = ev.evaluate()["sem_seg"]
        if not all(np.isfinite([res["mIoU"], res["pACC"]])):
            raise AssertionError(f"semantic evaluation: {res}")
    h = cfg.MODEL.SEM_SEG_HEAD
    n_serve, n_train = serve_batch, len(batch["image"])
    print(f"semantic: SemanticSegmentor R-50-FPN ({C} classes, {h.NORM} head {h.CONVS_DIM} wide) serving bf16 "
          f"B={n_serve} at 832x1344 {serve_ms:.2f} ms/batch ({n_serve * 1e3 / serve_ms:.2f} img/s); training AMP "
          f"B={n_train} {ms:.2f} ms/iter ({n_train * 1e3 / ms:.2f} img/s), peak memory {peak:.2f} GiB, loss_sem_seg "
          f"{first:.5f} (ln {C} = "
          f"{math.log(C):.5f}) to {last:.5f} after {TASK_ITERS + 1} steps; SemSegEvaluator on the trained model's "
          f"card predictions of its batch: mIoU {res['mIoU']:.4f} pACC {res['pACC']:.4f} (TF32 convolutions; no "
          f"TPU kernel) {tag}")


def dense_reference_cfg(kind: str, device: str):
    """Phase 39's narrow models: ``dense_opts(kind, narrow=True)`` at
    float32, POOLER_IMPL pallas_train (K2 forward and K3 backward on the
    card, their plain versions on the CPU)."""
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(BASE_YAML)
    cfg.merge_from_list(dense_opts(kind, narrow=True) + ["MODEL.ROI_HEADS.POOLER_IMPL", "pallas_train",
                                                          "MODEL.DEVICE", device])
    return cfg


def dense_reference_check(tag, kinds=("retinanet", "semantic", "panoptic")):
    """Phase 39a: the narrow RetinaNet, SemanticSegmentor and PanopticFPN
    (``dense_reference_cfg``) at float32 on the card and on the CPU from the
    same weights (``calibrated_init``; RetinaNet's score bias at the prior,
    Panoptic FPN's mask predictor scaled by 0.05 as phase 35's), each held
    to its own float64 witness on the CPU (``witness_lines``,
    ``witness_limit``; the witnesses take each run's decisions at the mask
    head's ReLUs): one training step's losses and trainable gradients on a
    B=2 ``dense_batch`` of 128x192, then the eval forward: detections (boxes
    px, scores), masks (abs) and the semantic logits (abs, over the largest).
    K2/K3 2/2 a step and 0/2 an eval forward for Panoptic FPN on the card,
    none for the others."""
    import copy

    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model

    batch = dense_batch(2, 128, 192, 4, seed=3, device="cpu", num_classes=5, sem_classes=7, n_gt=(3, 3),
                        size=(24, 100))
    for kind in kinds:
        cfg = dense_reference_cfg(kind, "cpu")
        cpu = build_model(cfg, device="cpu")
        calibrated_init(cpu, seed=0)
        with torch.no_grad():
            for name, t in cpu.state_dict().items():
                if name == "head.cls_score.bias":
                    t.fill_(-math.log(99.0))
                if name.startswith("roi_heads.mask_head.predictor."):
                    t.mul_(0.05)
        witness = copy.deepcopy(cpu).double()
        witness.compute_dtype = torch.float64
        gpu_cfg = cfg.clone()
        gpu_cfg.MODEL.DEVICE = CARD
        gpu = build_model(gpu_cfg, device=CARD)
        gpu.load_state_dict(cpu.state_dict())
        res, flips = {}, {}
        for key, model in (("cpu", cpu), ("gpu", gpu)):
            decided = {}
            with relu_decisions(model, record=decided):
                res[key] = extra_heads_run(model, cfg, batch, True)
            with relu_decisions(witness, follow=decided):
                res["f64 " + key] = extra_heads_run(witness, cfg, batch, True)
            flips[key] = decided.get("flips", 0)
        (c_loss, c_grad, c_out, _, _), (g_loss, g_grad, g_out, g_step, g_eval) = res["cpu"], res["gpu"]
        (w_loss, w_grad, w_out, _, _), (v_loss, v_grad, _, _, _) = res["f64 cpu"], res["f64 gpu"]
        want_n = ((2, 2), (0, 2)) if kind == "panoptic" else ((0, 0), (0, 0))
        if (g_step, g_eval) != want_n or set(c_loss) != set(g_loss) or set(c_grad) != set(g_grad):
            raise AssertionError(f"{kind} reference: card launches {g_step}/{g_eval} or losses {sorted(g_loss)}")
        lines = witness_lines(kind, (w_loss, c_loss, v_loss, g_loss), (w_grad, c_grad, v_grad, g_grad))
        errs = []
        if kind != "semantic":
            w_dets, c_dets, g_dets = (o["instances"] if kind == "panoptic" else o for o in (w_out, c_out, g_out))
            n, c_box, c_score = detection_errors(f"{kind} CPU vs float64", w_dets, c_dets)
            _, g_box, g_score = detection_errors(f"{kind} card vs float64", w_dets, g_dets)
            errs += [("boxes (px)", "box", g_box, c_box), ("scores", "score", g_score, c_score)]
            if kind == "panoptic":
                v = w_dets.valid
                c_m, g_m = [float((d.masks[v].double() - w_dets.masks[v]).abs().max()) for d in (c_dets, g_dets)]
                errs.append(("masks", "score", g_m, c_m))
            lines.append(f"eval {n} valid detections")
        if kind != "retinanet":
            w_sem, c_sem, g_sem = (o["sem_seg"] if kind == "panoptic" else o for o in (w_out, c_out, g_out))
            top = float(w_sem.abs().max())
            c_s, g_s = [float((x.double() - w_sem).abs().max()) / top for x in (c_sem, g_sem)]
            errs.append(("semantic logits (over the largest)", "score", g_s, c_s))
        for what, kind_limit, g_err, c_err in errs:
            if g_err > witness_limit(kind_limit, c_err):
                raise AssertionError(f"{kind} reference: card {what} {g_err:.3e} from float64, the CPU's {c_err:.3e} "
                                     f"(limit {witness_limit(kind_limit, c_err):.3e})")
            lines.append(f"{what} card {g_err:.3e} CPU {c_err:.3e} (limit {witness_limit(kind_limit, c_err):.3e})")
        print(f"{kind} reference (card and CPU float32 against CPU float64, narrow): " + "; ".join(lines) +
              f"; ReLU decisions the witnesses took over from the card's run {flips['gpu']}, the CPU's "
              f"{flips['cpu']}; K2/K3 a step {g_step[0]}/{g_step[1]}, K1/K2 an eval {g_eval[0]}/{g_eval[1]} {tag}")


def cityscapes_check(tag):
    """Phase 39b: a seeded Cityscapes tree of 1024x2048 frames
    (``write_cityscapes_tree``: 2 cities, 3 frames each) through the port's
    loaders (``register_cityscapes``) and both evaluators from the card's
    tensors: ``CityscapesInstanceEvaluator`` on the oracle boxes built on
    the card (``cityscapes_oracle``) must give box AP 100, and moved 3 px an
    AP inside ``CITYSCAPES_SHIFTED_AP``; ``CityscapesSemSegEvaluator`` on the
    argmax (on the card) of one-hot logits of the labelIds maps must give
    mIoU 100."""
    import numpy as np
    import torch
    from PIL import Image

    from lvc_tpu_torch.data.catalog import DatasetCatalog
    from lvc_tpu_torch.data.cityscapes import register_cityscapes
    from lvc_tpu_torch.evaluation.cityscapes_evaluation import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_cityscapes_tree(tmp, per_city=3, hw=(1024, 2048))
        inst, sem = register_cityscapes(tmp, "val")
        tree_s = time.perf_counter() - t0
        dicts = DatasetCatalog.get(inst)
        aps = {}
        for shift in (0.0, 3.0):
            ev = CityscapesInstanceEvaluator(inst)
            for image_id, hw, boxes, classes, dets in cityscapes_oracle(dicts, CARD, shift):
                ev.process_image(image_id, hw, boxes, classes, to_cpu(dets))
            aps[shift] = ev.evaluate()["bbox"]
        ev = CityscapesSemSegEvaluator(sem)
        for d in DatasetCatalog.get(sem):
            gt = torch.from_numpy(np.asarray(Image.open(d["sem_seg_file_name"]), np.int64)).to(CARD)
            logits = torch.nn.functional.one_hot(torch.where(gt == 255, 0, gt), 19).permute(2, 0, 1).float()
            ev.process(logits.argmax(0).cpu().numpy(), gt.cpu().numpy())
        miou = ev.evaluate()["sem_seg"]["mIoU"]
    n_gt = sum(len(d["annotations"]) for d in dicts)
    crowd = sum(a["iscrowd"] for d in dicts for a in d["annotations"])
    if abs(aps[0.0]["AP"] - 100.0) > 1e-9 or not CITYSCAPES_SHIFTED_AP[0] < aps[3.0]["AP"] < CITYSCAPES_SHIFTED_AP[1] \
            or abs(miou - 100.0) > 1e-9:
        raise AssertionError(f"cityscapes: oracle AP {aps[0.0]}, moved 3 px {aps[3.0]} (want inside "
                             f"{CITYSCAPES_SHIFTED_AP}), oracle mIoU {miou}")
    print(f"cityscapes: {len(dicts)} frames at 1024x2048 written and registered in {tree_s:.1f} s, {n_gt} instances "
          f"({crowd} crowd) from the polygons; oracle box AP {aps[0.0]['AP']:.4f} AP50 {aps[0.0]['AP50']:.4f}; moved "
          f"3 px AP {aps[3.0]['AP']:.4f} (want inside {CITYSCAPES_SHIFTED_AP}); oracle labelIds mIoU {miou:.4f} {tag}")


def dense_reference_phase(tag):
    """Phase 39: ``dense_reference_check`` then ``cityscapes_check``."""
    dense_reference_check(tag)
    cityscapes_check(tag)


# ---------------------------------------------------------------------------
# Phases 40-44: the alternative backbones and the rotated family
# ---------------------------------------------------------------------------
BACKBONE_NAMES = {"swin": "Swin-T FPN Faster R-CNN", "resnet_d": "ResNet-D R-50-FPN Faster R-CNN",
                  "dcn": "R-50-FPN DCN v1 c3-c5", "dcn_v2": "R-50-FPN DCN v2 c3-c5"}
ROTATED_B, ROTATED_G, ROTATED_PROPOSALS = 8, 16, 2000  # phase 43: images, gt slots and proposals an image
ROTATED_TURN = 15.0  # phase 43: the oracle boxes turned by this many degrees for the second evaluation
ROTATED_AP = (20.0, 60.0)  # the AP predicted for them (PERF.md, before the first card run)


def backbone_opts(kind: str):
    """The options of phases 40-42's and 44's backbones, for either
    package's config: ``swin`` is build_swin_transformer_fpn_backbone with
    Swin-T (embed 96, depths 2-2-6-2, heads 3-6-12-24, window 7);
    ``resnet_d`` the ResNet-D R-50 (MODEL.RESNETS.D); ``dcn`` and ``dcn_v2``
    R-50 with deformable 3x3s in res3-res5 as detectron2's
    mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml (DCN v1) and
    mask_rcnn_R_50_FPN_3x_dconv_c3-c5 style DCN v2 (DEFORM_MODULATED)."""
    if kind == "swin":
        return ["MODEL.BACKBONE.NAME", "build_swin_transformer_fpn_backbone", "MODEL.SWIN.SWIN_SIZE", "tiny"]
    if kind == "resnet_d":
        return ["MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.D", True]
    if kind in ("dcn", "dcn_v2"):
        return ["MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True],
                "MODEL.RESNETS.DEFORM_MODULATED", kind == "dcn_v2"]
    raise ValueError(f"no backbone {kind!r}")


def backbone_cfg(kind: str, impl: str = "pallas_fast"):
    """Base-RCNN-FPN.yaml (R-50-FPN Faster R-CNN, 80 classes) with
    ``backbone_opts(kind)``, built in code."""
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(BASE_YAML)
    cfg.merge_from_list(backbone_opts(kind) + ["MODEL.ROI_HEADS.POOLER_IMPL", impl])
    return cfg


def backbone_init(kind: str, model, seed: int = 0):
    """``damped_init``; for Swin every bias of the bottom-up then drawn from
    N(0, 0.02), as trained weights have them. With zero biases the canvas
    padding (0 after normalising, as in JAX) makes every padded token
    exactly 0 through every block, each LayerNorm sits at variance 0, where
    its backward scales by rsqrt(eps) = 316, and training blows up
    (``tests/test_torch_swin.py::test_zero_biases_blow_up_on_the_padding``;
    JAX's math is the same)."""
    import torch

    from lvc_tpu_torch.utils.init import damped_init

    damped_init(model, seed=seed)
    if kind == "swin":
        gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed + 1)
        with torch.no_grad():
            for name, t in model.state_dict().items():
                if name.startswith("backbone.bottom_up.") and name.endswith(".bias"):
                    t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * 0.02)
    return model


def backbone_serving(kind: str, kernels, tag, B: int = 8):
    """bf16 serving of ``backbone_cfg(kind)`` at B=``B`` on 832x1344 from
    seeded weights (``backbone_init``), score threshold 0.001, with POOLER_IMPL
    pallas_fast (K1) and auto (K2): a warm-up and 3 timed forwards each with
    every count set to 0 just before and read just after (one pool a
    forward), the peak memory, and one more forward recorded, its pool held
    to its plain version and timed (``check_recorded_pool``)."""
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import roi_align as ra

    batch = serving_batch(B)
    B = len(batch["image"])
    parts = []
    for impl, name in (("pallas_fast", "roi_align_band"), ("auto", "roi_align_paired")):
        cfg = backbone_cfg(kind, impl)
        cfg.MODEL.DTYPE = "bfloat16"
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.001
        model = backbone_init(kind, build_model(cfg))
        torch.cuda.reset_peak_memory_stats()
        model(batch)
        torch.cuda.synchronize()
        ra.roi_align_band.launches = ra.roi_align_paired.launches = 0
        t0 = time.perf_counter()
        for _ in range(3):
            dets = model(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        n = ra.roi_align_band.launches, ra.roi_align_paired.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if n != ((3, 0) if impl == "pallas_fast" else (0, 3)):
            raise AssertionError(f"{kind} serving {impl}: K1/K2 launches {n} over 3 forwards")
        check_detections(dets, B)
        if not dets.valid.any(dim=1).all():
            raise AssertionError(f"{kind} serving {impl}: an image kept no detection")
        rec = PoolRecorder()
        with rec:
            model(batch)
        times = check_recorded_pool(f"{kind} serving {impl} (B={B}, bf16)", rec, tag, timed=True)
        key = "K1" if impl == "pallas_fast" else "K2"
        add_launches(kernels, name, n[0] + n[1], times[key], rec.max_err[key])
        parts.append(f"{impl} {ms:.2f} ms/batch ({B * 1e3 / ms:.2f} img/s), K1/K2 {n[0]}/{n[1]}, peak memory "
                     f"{peak:.2f} GiB, valid detections {dets.valid.sum(dim=1).tolist()}")
        del model, rec
        torch.cuda.empty_cache()
    print(f"{kind} serving: {BACKBONE_NAMES[kind]} bf16 B={B} at 832x1344 (TF32 convolutions): " + "; ".join(parts)
          + f" {tag}")


def recorded_train_pool(what, trainer, kernels, tag):
    """One more step of a CLI's trainer recorded (``PoolRecorder``): its K2
    and K3 calls held to their plain versions and timed, their times added
    to the kernels line."""
    with PoolRecorder() as rec:
        trainer.run_step()
    if len(rec.fwd) != 1 or len(rec.bwd) != 1:
        raise AssertionError(f"{what}: recorded {len(rec.fwd)}/{len(rec.bwd)} K2/K3 calls in one step")
    times = check_recorded_pool(what, rec, tag, timed=True)
    for key, name in (("K2", "roi_align_paired"), ("K3", "roi_align_paired_bwd")):
        add_launches(kernels, name, 0, times[key], rec.max_err[key])


def swin_train_net(tag, kernels):
    """Phase 40b: the Swin-T Faster R-CNN through ``train_net.main`` in this
    process (``backbone_cfg("swin")`` on Base-RCNN-FPN.yaml: IMS_PER_BATCH 16
    at 832x1344, AMP, POOLER_IMPL auto) from a ``backbone_init`` ``.pth``,
    ``TASK_ITERS`` iterations on phase 17's seeded tree
    (``coco_trainval_base``, 60 classes), then its evaluation of
    ``coco_test_base`` at score threshold 0: ms/iter, data_time and peak
    memory as phase 17 reports them, K2/K3 1/1 every iteration; then one
    more step recorded (``recorded_train_pool``). The CLI's K2/K3 launches
    (training and evaluation) go to the kernels line."""
    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.tools import train_net

    cfg = backbone_cfg("swin", "auto")
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 60
    with tempfile.TemporaryDirectory() as tmp:
        weights = DetectionCheckpointer(backbone_init("swin", build_model(cfg)), os.path.join(tmp, "w")).save(
            "init", iteration=0)
        opts = [str(x) for x in backbone_opts("swin")] + [
            "MODEL.WEIGHTS", weights, "SOLVER.IMS_PER_BATCH", "16", "SOLVER.MAX_ITER", str(TASK_ITERS),
            "SOLVER.AMP.ENABLED", "True", "DATASETS.TRAIN", "('coco_trainval_base',)", "MODEL.ROI_HEADS.NUM_CLASSES",
            "60", "DATASETS.TEST", "('coco_test_base',)", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0", "SEED", "0",
            "OUTPUT_DIR", os.path.join(tmp, "out")]
        torch.cuda.reset_peak_memory_stats()
        res, secs, n, trainer = run_cli(train_net, ["--config-file", BASE_YAML] + opts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        hist = trainer.storage.histories()
        losses = [v for k, h in hist.items() if k.startswith("loss") for v in h.values()]
        ap = res["bbox"]["AP"]
        if trainer.cfg.MODEL.BACKBONE.NAME != "build_swin_transformer_fpn_backbone" or \
                len(trainer.step_s) != TASK_ITERS or set(trainer.step_launches) != {(1, 1)} or \
                not all(math.isfinite(v) for v in losses) or not math.isfinite(ap):
            raise AssertionError(f"swin train_net: {len(trainer.step_s)} steps, K2/K3 per iteration "
                                 f"{sorted(set(trainer.step_launches))}, AP {ap}")
        train_net_report(f"swin train_net: {BACKBONE_NAMES['swin']} 60 classes AMP, IMS_PER_BATCH 16 at 832x1344 "
                         f"(TF32 convolutions)", trainer, secs, peak, 16, tag)
        print(f"swin train_net: evaluation of coco_test_base at score threshold 0: bbox AP {ap:.4f}, "
              f"{trainer.test_s * 1e3 / TRAIN_NET_TREE[1]:.1f} ms/img {tag}")
        recorded_train_pool("swin train_net step (16 x 512 slots, AMP)", trainer, kernels, tag)
        kernels["roi_align_paired"]["launches"] += n[1]
        kernels["roi_align_paired_bwd"]["launches"] += n[2]


def swin_path(tag, kernels):
    """Phase 40: the Swin-T Faster R-CNN's bf16 serving
    (``backbone_serving``) and its training CLI (``swin_train_net``) on
    phase 17's tree (``coco_root``)."""
    with cli_tf32():
        backbone_serving("swin", kernels, tag)
        swin_train_net(tag, kernels)


def write_pseudo_annotations(src_json: str, out_json: str, seed: int = 0) -> int:
    """A pseudo-annotation file as the chain's retrain reads one
    (``DATASETS.DT_PATH``): ``src_json``'s images and boxes, each box
    jittered by up to 10% of its size, with a score, and one in four marked
    ``ignore_qe`` (an ignore region for the training loader). Returns the
    number of ignore regions."""
    import numpy as np

    with open(src_json) as f:
        data = json.load(f)
    rng = np.random.RandomState(seed)
    n_ignore = 0
    for a in data["annotations"]:
        x, y, w, h = a["bbox"]
        dx, dy, dw, dh = rng.uniform(-0.1, 0.1, 4)
        a["bbox"] = [max(x + dx * w, 0.0), max(y + dy * h, 0.0), w * (1 + dw), h * (1 + dh)]
        a["area"] = a["bbox"][2] * a["bbox"][3]
        a["score"] = float(rng.uniform(0.5, 1.0))
        a["ignore_qe"] = int(rng.rand() < 0.25)
        n_ignore += a["ignore_qe"]
    with open(out_json, "w") as f:
        json.dump(data, f)
    return n_ignore


def clip_update_check(trainer, tag):
    """On the card, from the gradients of the retrain's last step: the
    update one SGD step gives a bottom-up parameter under the CLIP optimizer
    is CLIP_LR / BASE_LR times the plain optimizer's, and a head
    parameter's equal, for the run's CLIP_LR and for a tenth of BASE_LR. The
    steps run on a float64 copy of the model (its weights and gradients), so
    no float32 rounding of the weights hides the ratio; held to rel 1e-6
    (the clipped updates are ~1e-9 of weights ~1e-2, so float64's rounding
    of the weights is ~1e-9 of them)."""
    import copy

    import torch

    from lvc_tpu_torch.solver.build import build_clip_optimizer, build_optimizer

    model = trainer.model.module if hasattr(trainer.model, "module") else trainer.model
    twin = copy.deepcopy(model).double()
    grads = {n: p.grad.double() for n, p in model.named_parameters() if p.grad is not None}
    start = {n: p.detach().clone() for n, p in twin.named_parameters()}
    names = ("backbone.bottom_up.res3.0.conv2.weight", "roi_heads.box_head.fc1.weight")
    if any(n not in grads for n in names):
        raise AssertionError(f"clip update: no gradient for {[n for n in names if n not in grads]}")
    parts = []
    for clip_lr in (trainer.cfg.SOLVER.CLIP_LR, trainer.cfg.SOLVER.BASE_LR / 10):
        cfg = trainer.cfg.clone()
        cfg.defrost()
        cfg.SOLVER.CLIP_LR = clip_lr
        moved = {}
        for build in (build_clip_optimizer, build_optimizer):
            with torch.no_grad():
                for n, p in twin.named_parameters():
                    p.copy_(start[n])
                    p.grad = grads[n].clone() if n in grads else None
            build(cfg, twin).step()
            moved[build] = {n: dict(twin.named_parameters())[n].detach() - start[n] for n in names}
        ratio = clip_lr / cfg.SOLVER.BASE_LR
        errs = []
        for n, want_ratio in zip(names, (ratio, 1.0)):
            a, b = moved[build_clip_optimizer][n], moved[build_optimizer][n]
            err = float((a - want_ratio * b).norm() / (want_ratio * b).norm().clamp(min=1e-300))
            if not err <= 1e-6 or float(b.norm()) == 0:
                raise AssertionError(f"clip update {n}: CLIP step against {want_ratio} x the plain one, rel {err}")
            errs.append(f"{n} ratio {float(a.norm() / b.norm()):.6f} (want {want_ratio:g}, rel {err:.1e})")
        parts.append(f"CLIP_LR {clip_lr:g} / BASE_LR {cfg.SOLVER.BASE_LR:g}: " + ", ".join(errs))
    print("resnet_d clip update on the card (one SGD step from the retrain's last gradients, float64): "
          + "; ".join(parts) + f" {tag}")


def retrain_cfg():
    """Phase 41's model: faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout.yaml
    with MODEL.RESNETS.D."""
    from lvc_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, FT_ALL_YAML))
    cfg.MODEL.RESNETS.D = True
    return cfg


class FusedRecorder:
    """While in use, stands in for the fused GEMM's wrapper in
    ``ops.fused_matmul``: keeps each call's arguments and passes the call
    on."""

    def __init__(self):
        from lvc_tpu_torch.ops import fused_matmul

        self.module, self.kernel, self.calls = fused_matmul, fused_matmul.matmul_affine_residual, []

    def __call__(self, x, w, scale, shift, residual, relu=True):
        self.calls.append((x, w, scale, shift, residual, relu))
        return self.kernel(x, w, scale, shift, residual, relu)

    def __enter__(self):
        self.module.matmul_affine_residual = self
        return self

    def __exit__(self, *exc):
        self.module.matmul_affine_residual = self.kernel


def resnet_d_fused_serving(tag, kernels, model_path: str, B: int = 8):
    """One bf16 serving batch of the retrained ResNet-D model with
    LVC_TPU_FUSED_RESIDUAL=1: the fused GEMM runs every bottleneck conv3
    and the FPN laterals (``fused_calls``); each call's own tensors held to
    the plain version (``fused_error``), the largest timed against its
    bound. A second forward counts the launches alone."""
    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.modeling.layers import fused_residual
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual as kernel
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual_plain as plain

    cfg = retrain_cfg()
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    model = build_model(cfg)
    DetectionCheckpointer(model).load(model_path)
    batch = serving_batch(B)
    B = len(batch["image"])
    per_forward = fused_calls(model)[0]
    with fused_residual(True), torch.no_grad():
        with FusedRecorder() as rec:
            model(batch)
        torch.cuda.synchronize()
        kernel.launches = 0
        t0 = time.perf_counter()
        dets = model(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = kernel.launches
    check_detections(dets, B)
    if len(rec.calls) != per_forward or n != per_forward:
        raise AssertionError(f"resnet_d fused serving: {len(rec.calls)} recorded calls, {n} launches, want "
                             f"{per_forward}")
    kernel.launches = 0
    max_err = 0.0
    for args in rec.calls:
        got = kernel(*args[:5], relu=args[5])
        want = plain(*args[:5], relu=args[5])
        ok, err, _, _, _ = fused_error(got, want, *args[:5])
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"resnet_d fused serving: a call {tuple(args[0].shape)} x {tuple(args[1].shape)} "
                                 f"differs from its plain version, max abs err {err}")
        max_err = max(max_err, err)
    if kernel.launches != len(rec.calls):
        raise AssertionError(f"resnet_d fused serving: {kernel.launches} launches for {len(rec.calls)} checks")
    big = max(rec.calls, key=lambda a: a[0].shape[0] * a[0].shape[1] * a[1].shape[1])
    M, K, N = big[0].shape[0], big[0].shape[1], big[1].shape[1]
    k_ms = cuda_ms(lambda: kernel(*big[:5], relu=big[5]), 20)
    p_ms = cuda_ms(lambda: plain(*big[:5], relu=big[5]), 3)
    bound_ms, bound_by, _, _ = fused_bound(M, K, N)
    add_launches(kernels, "matmul_affine_residual", n, (k_ms, p_ms, bound_ms, bound_by), max_err)
    print(f"resnet_d fused serving: ResNet-D R-50-FPN bf16 B={B} at 832x1344 with LVC_TPU_FUSED_RESIDUAL=1, "
          f"{ms:.2f} ms/batch, {n} fused launches a forward (want {per_forward}: every conv3 and 3 laterals); "
          f"all {len(rec.calls)} calls on their own tensors within 1 bf16 ulp + 1e-5 * S of the plain version, "
          f"max abs err {max_err:.3e}; the largest (M, K, N) ({M}, {K}, {N}): {k_ms:.4f} ms (plain "
          f"{p_ms:.3f} ms), bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / k_ms:.3f} {tag}")
    del model, rec
    torch.cuda.empty_cache()


def resnet_d_path(tag, kernels):
    """Phase 41, ResNet-D in LVC's retrain: ``train_net_qe_ig.main`` in this
    process on faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout.yaml as
    coco_full_run's step 18 runs it (80 classes, the cosine head, the
    backbone trained, IMS_PER_BATCH 16 at 832x1344) with MODEL.RESNETS.D,
    AMP, the CLIP optimizer at the defaults' SOLVER.CLIP_LR, gradient
    clipping at norm 1 and score threshold 0 as phase 22's chain, from a
    damped-init ``.pth``, ``TASK_ITERS`` iterations on a ``write_chain_tree``
    tree with a pseudo-annotation file (``write_pseudo_annotations``) in
    DATASETS.DT_PATH: ms/iter, data_time, peak memory, K2/K3 1/1 every
    iteration, the optimizer's bottom-up groups at CLIP_LR; one more step
    recorded (``recorded_train_pool``), the CLIP update on the card
    (``clip_update_check``), then one bf16 serving batch of the model with
    the fused path on (``resnet_d_fused_serving``)."""
    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.tools import coco_full_run, train_net_qe_ig
    from lvc_tpu_torch.utils.init import damped_init

    with cli_tf32(), tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "datasets")
        write_chain_tree(root, *CHAIN_TREE, sizes=((480, 640), (640, 480)), seed=0, max_boxes=8)
        pseudo = os.path.join(tmp, "pseudo_wbase.json")
        n_ignore = write_pseudo_annotations(os.path.join(root, "cocosplit", "datasplit", "trainvalno5k.json"), pseudo)
        weights = DetectionCheckpointer(damped_init(build_model(retrain_cfg()), seed=0), os.path.join(tmp, "w")).save(
            "init", iteration=0)
        opts = ["MODEL.RESNETS.D", "True", "MODEL.WEIGHTS", weights, "SOLVER.MAX_ITER", str(TASK_ITERS),
                "SOLVER.AMP.ENABLED", "True", "DATASETS.DT_PATH", f"('{pseudo}',)", "QUERY_EXPAND.ENABLED", "True",
                "MODEL.BACKBONE.FREEZE", "False", "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0",
                "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0", "SEED", "0", "OUTPUT_DIR", os.path.join(tmp, "out")]
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            coco_full_run.use_datasets(root)
            torch.cuda.reset_peak_memory_stats()
            res, secs, n, trainer = run_cli(train_net_qe_ig, ["--config-file", os.path.join(REPO, FT_ALL_YAML)] + opts,
                                            trainer="TrainerQEIgnore")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            os.chdir(cwd)
        c = trainer.cfg
        bottom_up = {id(p) for name, p in trainer.model.named_parameters() if ".bottom_up." in name}
        lrs = {(any(id(p) in bottom_up for p in g["params"]), g["initial_lr"]) for g in trainer.optimizer.param_groups}
        want_lrs = {(True, c.SOLVER.CLIP_LR), (False, c.SOLVER.BASE_LR)}
        if not c.MODEL.RESNETS.D or len(trainer.step_s) != TASK_ITERS or set(trainer.step_launches) != {(1, 1)} \
                or lrs != want_lrs:
            raise AssertionError(f"resnet_d retrain: D {c.MODEL.RESNETS.D}, {len(trainer.step_s)} steps, K2/K3 per "
                                 f"iteration {sorted(set(trainer.step_launches))}, group learning rates {lrs}")
        train_net_report(f"resnet_d retrain: train_net_qe_ig ResNet-D R-50-FPN 80 classes (cosine head, backbone "
                         f"trained, CLIP_LR {c.SOLVER.CLIP_LR:g} at BASE_LR {c.SOLVER.BASE_LR:g}) AMP, IMS_PER_BATCH "
                         f"16 at 832x1344 with {n_ignore} ignore regions in the pseudo-annotations (TF32 "
                         f"convolutions)", trainer, secs, peak, 16, tag)
        recorded_train_pool("resnet_d retrain step (16 x 512 slots, AMP)", trainer, kernels, tag)
        kernels["roi_align_paired"]["launches"] += n[1]
        kernels["roi_align_paired_bwd"]["launches"] += n[2]
        clip_update_check(trainer, tag)
        model_path = last_checkpoint(os.path.join(tmp, "out"))
        del trainer
        torch.cuda.empty_cache()
        resnet_d_fused_serving(tag, kernels, model_path)


def dcn_path(tag, kernels):
    """Phase 42, the deformable R-50 (``task_cfg("dcn")``, detectron2's
    Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml on Base-RCNN-FPN.yaml):
    ``task_serving`` at B=8 in bf16 (K1 twice a forward, then K2 twice) and
    ``task_train`` at IMS_PER_BATCH 16, AMP, ``TASK_ITERS`` steps (K2/K3
    twice a step), with its peak memory."""
    with cli_tf32():
        task_serving("dcn", kernels, tag)
        task_train("dcn", kernels, tag, B=16, amps=(True,))


def polygon_iou(a, b) -> float:
    """IoU of two XYWHA boxes by Sutherland-Hodgman clipping in float64 on
    the host: an independent witness of the rotated IoU."""
    import numpy as np

    def corners(box):
        cx, cy, w, h, ang = box
        t = np.deg2rad(ang)
        c, s = np.cos(t), np.sin(t)
        return [np.array([cx + dx * c + dy * s, cy - dx * s + dy * c])
                for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2), (-w / 2, h / 2))]

    def area(poly):
        return 0.5 * abs(sum(p[0] * q[1] - q[0] * p[1] for p, q in zip(poly, poly[1:] + poly[:1])))

    def cross(u, v):
        return u[0] * v[1] - u[1] * v[0]

    p, q = corners(a), corners(b)
    sign = 1.0 if cross(q[1] - q[0], q[2] - q[1]) >= 0 else -1.0
    out = p
    for e0, e1 in zip(q, q[1:] + q[:1]):
        inp, out = out, []
        for i, cur in enumerate(inp):
            nxt = inp[(i + 1) % len(inp)]
            cin = sign * cross(e1 - e0, cur - e0) >= 0
            nin = sign * cross(e1 - e0, nxt - e0) >= 0
            if cin:
                out.append(cur)
            if cin != nin:
                d = nxt - cur
                t = cross(e1 - e0, e0 - cur) / cross(e1 - e0, d)
                out.append(cur + t * d)
        if not out:
            return 0.0
    inter = area(out)
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def rotated_batch(B, G, P, H, W, seed, device, num_classes=80):
    """Seeded rotated gt (B, G, 5): G boxes an image of 32-400 px sides,
    aspect up to 4, any angle, inside the H x W image, and P proposals an
    image jittered about them (centre by 20% of the size, sides by
    exp(N(0, 0.25)), angle by N(0, 12) degrees)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    w = rng.uniform(32, 400, (B, G))
    h = np.clip(w / rng.uniform(0.25, 4.0, (B, G)), 24, 400)
    r = np.hypot(w, h) / 2
    cx = rng.uniform(r, W - r)
    cy = rng.uniform(np.minimum(r, H / 2 - 1), np.maximum(H - r, H / 2 + 1))
    gt = np.stack([cx, cy, w, h, rng.uniform(-180, 180, (B, G))], -1).astype(np.float32)
    src = gt[np.arange(B)[:, None], rng.randint(0, G, (B, P))]
    noise = rng.normal(0, 1, (B, P, 5))
    props = np.stack([src[..., 0] + 0.2 * src[..., 2] * noise[..., 0], src[..., 1] + 0.2 * src[..., 3] * noise[..., 1],
                      src[..., 2] * np.exp(0.25 * noise[..., 2]), src[..., 3] * np.exp(0.25 * noise[..., 3]),
                      src[..., 4] + 12 * noise[..., 4]], -1).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return {"gt_boxes": t(gt), "gt_classes": t(rng.randint(0, num_classes, (B, G))),
            "gt_valid": t(np.ones((B, G), bool)), "proposals": t(props), "proposal_valid": t(np.ones((B, P), bool)),
            "image_size": t(np.array([[H, W]] * B, np.int32))}


def rroi_heads_cfg_args(num_classes: int = 80, **kw):
    """``RROIHeads``' options from Base-RCNN-FPN.yaml's ROI heads (p2-p5, box
    head 2 fc 1024, 512 samples an image at 25% positives) with
    detectron2's rotated box weights (10, 10, 5, 5, 1)."""
    args = dict(num_classes=num_classes, batch_size_per_image=512, positive_fraction=0.25, fc_dim=1024,
                score_thresh_test=0.05, detections_per_image=100)
    args.update(kw)
    return args


def rotated_evaluation(tag, gt, classes, device):
    """``RotatedCOCOEvaluator`` on oracle detections (the gt boxes, score 1:
    AP 100) and on the gt turned by ``ROTATED_TURN`` degrees, scored by
    their host-side IoU with their gt (``polygon_iou``), so that the AP is
    known: in each class, at each IoU threshold t, the detections at IoU >=
    t rank first, and AP_t is the share of the 101 recall points at or below
    their fraction; the mean over classes and thresholds must equal the
    measured AP, and lie in ``ROTATED_AP``."""
    import numpy as np
    import torch

    from lvc_tpu_torch.data.builtin_meta import COCO_CATEGORIES, _get_builtin_metadata
    from lvc_tpu_torch.data.catalog import DatasetCatalog
    from lvc_tpu_torch.data.meta_coco import register_meta_coco
    from lvc_tpu_torch.evaluation.rotated_coco_evaluation import RotatedCOCOEvaluator
    from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections

    B, G = classes.shape
    meta = _get_builtin_metadata("coco")
    rev = {v: k for k, v in meta["thing_dataset_id_to_contiguous_id"].items()}
    g = gt.cpu().numpy().astype(np.float64)
    cls = classes.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        anns = [{"id": i * G + j + 1, "image_id": i + 1, "category_id": rev[int(cls[i, j])], "bbox": list(g[i, j]),
                 "area": float(g[i, j, 2] * g[i, j, 3]), "iscrowd": 0} for i in range(B) for j in range(G)]
        path = os.path.join(tmp, "rotated.json")
        with open(path, "w") as f:
            json.dump({"images": [{"id": i + 1, "file_name": f"{i}.jpg", "height": 832, "width": 1344}
                                  for i in range(B)], "annotations": anns,
                       "categories": [{"id": c["id"], "name": c["name"]} for c in COCO_CATEGORIES]}, f)
        name = "rotated_oracle_test"
        if name in DatasetCatalog:
            DatasetCatalog.remove(name)
        register_meta_coco(name, meta, tmp, path)
        turned = gt.clone()
        turned[..., 4] += ROTATED_TURN
        ious = np.array([[polygon_iou(g[i, j], turned[i, j].cpu().numpy().astype(np.float64)) for j in range(G)]
                         for i in range(B)])
        predicted = 100 * np.mean([[(np.floor(np.mean(ious[cls == c] >= t) * 100 + 1e-9) + 1) / 101
                                    if (ious[cls == c] >= t).any() else 0.0 for t in np.linspace(0.5, 0.95, 10)]
                                   for c in np.unique(cls)])
        aps = {}
        metas = [{"image_id": i + 1, "image_size": (832, 1344), "orig_size": (832, 1344)} for i in range(B)]
        for what, boxes, scores in (("oracle", gt, torch.ones(B, G, device=device)),
                                    (f"turned {ROTATED_TURN:g} degrees", turned,
                                     torch.from_numpy(ious.astype(np.float32)).to(device))):
            ev = RotatedCOCOEvaluator(name)
            ev.reset()
            t0 = time.perf_counter()
            ev.process_detections(Detections(boxes, scores, classes, torch.ones_like(classes, dtype=torch.bool),
                                              torch.zeros_like(classes)), metas)
            aps[what] = (ev.evaluate()["bbox"]["AP"], time.perf_counter() - t0)
    oracle, turned_ap = aps["oracle"][0], aps[f"turned {ROTATED_TURN:g} degrees"][0]
    if abs(oracle - 100.0) > 1e-9 or abs(turned_ap - predicted) > 1e-6 or \
            not ROTATED_AP[0] <= turned_ap <= ROTATED_AP[1]:
        raise AssertionError(f"rotated evaluation: oracle AP {oracle}, turned AP {turned_ap} (host prediction "
                             f"{predicted}, predicted range {ROTATED_AP})")
    print(f"rotated evaluation: RotatedCOCOEvaluator on {B} x {G} rotated gt of {B} 832x1344 images: oracle AP "
          f"{oracle:.4f} in {aps['oracle'][1]:.2f} s; turned {ROTATED_TURN:g} degrees (IoU with their gt "
          f"{ious.min():.3f}-{ious.max():.3f}, mean {ious.mean():.3f}) AP {turned_ap:.4f}, the host's prediction "
          f"{predicted:.4f}, inside the predicted {ROTATED_AP} {tag}")


def rroi_heads_path(tag):
    """Phase 43: ``RROIHeads`` at full width (``rroi_heads_cfg_args``: 80
    classes, 256-channel p2-p5 of a damped R-50-FPN's bf16 forward of a
    B=8 832x1344 batch), ``ROTATED_PROPOSALS`` rotated proposals an image
    jittered about ``ROTATED_G`` seeded rotated gts (``rotated_batch``):
    ``TASK_ITERS`` AMP training steps of the heads (bf16 features, SGD on the
    heads' float32 parameters) after a warm-up, ms/step and peak memory,
    every loss finite; inference at score threshold 0, so that 2,048
    candidates an image reach the class-aware rotated NMS (recorded), 3
    timed forwards, detections (8, 100, 5) finite; then
    ``rotated_evaluation``. No TPU kernel runs here: the rotated pool is
    torch ops, as it is XLA in JAX."""
    import torch

    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.modeling.roi_heads import rotated_fast_rcnn as rfr
    from lvc_tpu_torch.modeling.sampling import per_image_generators
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.utils.init import damped_init

    B, G, P = ROTATED_B, ROTATED_G, ROTATED_PROPOSALS
    cfg = get_cfg()
    cfg.merge_from_file(BASE_YAML)
    cfg.MODEL.DTYPE = "bfloat16"
    detector = damped_init(build_model(cfg), seed=0)
    with torch.no_grad(), cli_tf32():
        feats = {k: v.detach() for k, v in detector.backbone_features(serving_batch(B)).items()}
    del detector
    torch.cuda.empty_cache()
    data = rotated_batch(B, G, P, 832, 1344, seed=0, device=CARD)
    strides = {"p2": 4, "p3": 8, "p4": 16, "p5": 32}
    heads = rfr.RROIHeads(tuple(strides), strides, 256, **rroi_heads_cfg_args()).to(CARD)
    damped_init(heads, seed=0)
    gt = {"boxes": data["gt_boxes"], "classes": data["gt_classes"], "valid": data["gt_valid"]}
    opt = torch.optim.SGD(heads.parameters(), lr=0.02, momentum=0.9)
    ra.roi_align_band.launches = ra.roi_align_paired.launches = ra.roi_align_paired_bwd.launches = 0

    def step(i):
        heads.train()
        losses = heads(feats, data["proposals"], data["proposal_valid"], data["image_size"], gt,
                       per_image_generators(i, B, CARD))
        opt.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        opt.step()
        return {k: float(v) for k, v in losses.items()}

    torch.cuda.reset_peak_memory_stats()
    first = step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [step(i + 1) for i in range(TASK_ITERS)]
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3 / TASK_ITERS
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if set(first) != {"loss_cls", "loss_box_reg"} or not all(math.isfinite(v) for m in metrics for v in m.values()) \
            or abs(first["loss_cls"] - math.log(81)) > 0.05 or first["loss_box_reg"] <= 0:
        raise AssertionError(f"rroi heads training: first {first}, last {metrics[-1]}")
    heads.eval()
    heads.score_thresh = 0.0
    seen, nms = [], rfr.batched_nms_rotated_mask
    rfr.batched_nms_rotated_mask = lambda *a: seen.append(a[3].sum(1).tolist()) or nms(*a)
    try:
        with torch.no_grad():
            heads(feats, data["proposals"], data["proposal_valid"], data["image_size"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(3):
                dets = heads(feats, data["proposals"], data["proposal_valid"], data["image_size"])
            torch.cuda.synchronize()
    finally:
        rfr.batched_nms_rotated_mask = nms
    infer_ms = (time.perf_counter() - t0) * 1e3 / 3
    infer_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = ra.roi_align_band.launches, ra.roi_align_paired.launches, ra.roi_align_paired_bwd.launches
    if tuple(dets.boxes.shape) != (B, 100, 5) or not torch.isfinite(dets.boxes).all() or \
            not dets.valid.all() or any(c != [2048] * B for c in seen) or n != (0, 0, 0):
        raise AssertionError(f"rroi heads inference: boxes {tuple(dets.boxes.shape)}, valid "
                             f"{dets.valid.sum(1).tolist()}, NMS candidates {seen[:1]}, K1/K2/K3 {n}")
    print(f"rroi heads: RROIHeads 80 classes on a damped R-50-FPN's bf16 p2-p5 of B={B} 832x1344, {P} rotated "
          f"proposals and {G} gt an image: AMP training (bf16 features) {train_ms:.2f} ms/step over {TASK_ITERS} "
          f"steps, peak memory {train_peak:.2f} GiB, loss_cls {first['loss_cls']:.5f} (ln 81 = {math.log(81):.5f}) "
          f"to {metrics[-1]['loss_cls']:.5f}, loss_box_reg {first['loss_box_reg']:.5f} to "
          f"{metrics[-1]['loss_box_reg']:.5f}; inference at score threshold 0: {infer_ms:.2f} ms/batch "
          f"({B * 1e3 / infer_ms:.2f} img/s), peak memory {infer_peak:.2f} GiB, rotated NMS over "
          f"{seen[0][0]} candidates an image, detections {tuple(dets.boxes.shape)}; K1/K2/K3 0/0/0 {tag}")
    rotated_evaluation(tag, data["gt_boxes"], data["gt_classes"], CARD)


def variant_reference_cfg(kind: str, device: str):
    """Phase 44's narrow detectors: phase 25's narrow R-50-FPN
    (``extra_heads_cfg("StandardROIHeads")`` without DEBUG: float32,
    exhaustive sampling, POOLER_IMPL pallas_train) with ``backbone_opts``'s
    backbone (Swin-T whole; the R-50s at phase 25's widths)."""
    cfg = extra_heads_cfg("StandardROIHeads", device)
    cfg.DEBUG = False
    cfg.merge_from_list(backbone_opts(kind))
    return cfg


def rroi_reference_run(heads, feats, data, train: bool):
    """One training forward and backward (losses, float64 gradients of every
    parameter and of the features) or one eval forward (detections on the
    CPU) of narrow ``RROIHeads``; float64 heads run under
    ``float64_witness``."""
    import contextlib

    import torch

    witness = next(heads.parameters()).dtype == torch.float64
    feats = {k: v.clone().requires_grad_(train) for k, v in feats.items()}
    gt = {"boxes": data["gt_boxes"], "classes": data["gt_classes"], "valid": data["gt_valid"]}
    with float64_witness() if witness else contextlib.nullcontext():
        if not train:
            heads.eval()
            with torch.no_grad():
                return to_cpu(heads(feats, data["proposals"], data["proposal_valid"], data["image_size"]))
        heads.train()
        heads.zero_grad(set_to_none=True)
        losses = heads(feats, data["proposals"], data["proposal_valid"], data["image_size"], gt,
                       torch.Generator().manual_seed(0))
        sum(losses.values()).backward()
    grads = {n: p.grad.detach().cpu().double() for n, p in heads.named_parameters()}
    grads.update({f"feature {k}": v.grad.detach().cpu().double() for k, v in feats.items()})
    return {k: float(v) for k, v in losses.items()}, grads


def rroi_reference_check(tag):
    """Phase 44b: narrow ``RROIHeads`` (p2-p5 of a B=2 128x160 canvas, 16
    channels, FC 32, 6 classes, exhaustive sampling) at float32 on the card
    and on the CPU from the same weights (``damped_init`` with the
    predictor scaled up for spread scores), each held to its float64
    witness on the CPU (``witness_lines``): one training step's losses and
    the gradients of every parameter and of the features, then the
    detections (5-dim boxes, px, and scores; ``detection_errors``)."""
    import copy

    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.roi_heads.rotated_fast_rcnn import RROIHeads
    from lvc_tpu_torch.utils.init import damped_init

    strides = {"p2": 4, "p3": 8, "p4": 16, "p5": 32}
    rng = np.random.RandomState(0)
    feats = {k: torch.from_numpy(rng.randn(2, 16, 128 // s, 160 // s).astype(np.float32)).contiguous(
        memory_format=torch.channels_last) for k, s in strides.items()}
    data = rotated_batch(2, 4, 40, 128, 160, seed=1, device="cpu", num_classes=6)
    args = rroi_heads_cfg_args(num_classes=6, batch_size_per_image=128, positive_fraction=0.999, fc_dim=32,
                               score_thresh_test=0.01, detections_per_image=12)
    cpu = damped_init(RROIHeads(tuple(strides), strides, 16, **args), seed=0)
    with torch.no_grad():
        cpu.box_head.fc1.weight.mul_(20.0)
        cpu.box_head.fc2.weight.mul_(20.0)
        cpu.box_predictor.cls_score.weight.mul_(100.0)
        cpu.box_predictor.bbox_pred.weight.mul_(10.0)
    witness = copy.deepcopy(cpu).double()
    gpu = copy.deepcopy(cpu).to(CARD)
    card = lambda d: {k: (v.to(CARD) if hasattr(v, "to") else v) for k, v in d.items()}  # noqa: E731
    f64 = {k: v.double() for k, v in feats.items()}
    runs = {"cpu": (cpu, feats, data), "f64": (witness, f64, data), "gpu": (gpu, card(feats), card(data))}
    train = {k: rroi_reference_run(m, f, d, True) for k, (m, f, d) in runs.items()}
    dets = {k: rroi_reference_run(m, f, d, False) for k, (m, f, d) in runs.items()}
    lines = witness_lines("rroi heads", tuple(train[k][0] for k in ("f64", "cpu", "f64", "gpu")),
                          tuple(train[k][1] for k in ("f64", "cpu", "f64", "gpu")))
    n, c_box, c_score = detection_errors("rroi heads CPU vs float64", dets["f64"], dets["cpu"])
    _, g_box, g_score = detection_errors("rroi heads card vs float64", dets["f64"], dets["gpu"])
    if g_box > witness_limit("box", c_box) or g_score > witness_limit("score", c_score):
        raise AssertionError(f"rroi heads reference: card boxes {g_box:.3e} px, scores {g_score:.3e} from float64 "
                             f"(the CPU's {c_box:.3e}, {c_score:.3e})")
    print(f"rroi heads reference (card and CPU float32 against CPU float64, narrow): " + "; ".join(lines) +
          f"; eval {n} valid detections {tuple(dets['gpu'].boxes.shape)}, boxes card {g_box:.3e} px CPU {c_box:.3e} "
          f"(limit {witness_limit('box', c_box):.3e}), scores card {g_score:.3e} CPU {c_score:.3e} {tag}")


def variant_reference_check(tag, kinds=("swin", "resnet_d", "dcn", "dcn_v2"), rotated=True):
    """Phase 44: the narrow Swin-FPN, ResNet-D (its step with the CLIP
    optimizer), DCN v1 and DCN v2 detectors (``variant_reference_cfg``) at
    float32 on the card and on the CPU from the same weights
    (``calibrated_init``), each held to its float64 witness on the CPU
    (``witness_lines``, ``witness_limit``): one training step's losses and
    trainable gradients (K2/K3 1/1 on the card), then the eval forward's
    detections (K2 1); then (``rotated``) ``rroi_reference_check``. The
    deformable offset
    convs are scaled to 0.05 of ``calibrated_init``'s: offsets of a few
    tenths of a pixel (at its scale they are several pixels in each of 13
    stacked blocks, and float32 on the CPU alone then strays from float64
    in the backbone's gradients and in which detections it keeps)."""
    import copy

    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.solver.build import build_clip_optimizer, build_optimizer

    batch = train_batch(2, 128, 192, 4, seed=3, device="cpu", num_classes=5, n_gt=(3, 3), size=(24, 100))
    for kind in kinds:
        cfg = variant_reference_cfg(kind, "cpu")
        cfg.SOLVER.CLIP_LR = cfg.SOLVER.BASE_LR / 10
        optimizer = build_clip_optimizer if kind == "resnet_d" else build_optimizer
        cpu = build_model(cfg, device="cpu")
        calibrated_init(cpu, seed=0)
        with torch.no_grad():
            for name, t in cpu.state_dict().items():
                if "_offset." in name:
                    t.mul_(0.05)
        witness = copy.deepcopy(cpu).double()
        witness.compute_dtype = torch.float64
        gpu_cfg = cfg.clone()
        gpu_cfg.MODEL.DEVICE = CARD
        gpu = build_model(gpu_cfg, device=CARD)
        gpu.load_state_dict(cpu.state_dict())
        res = {key: extra_heads_run(model, cfg, batch, True, optimizer=optimizer)
               for key, model in (("cpu", cpu), ("f64", witness), ("gpu", gpu))}
        (c_loss, c_grad, c_dets, _, _), (w_loss, w_grad, w_dets, _, _), (g_loss, g_grad, g_dets, g_step, g_eval) = (
            res["cpu"], res["f64"], res["gpu"])
        if (g_step, g_eval) != ((1, 1), (0, 1)):
            raise AssertionError(f"{kind} reference: card launches {g_step}/{g_eval}")
        lines = witness_lines(kind, (w_loss, c_loss, w_loss, g_loss), (w_grad, c_grad, w_grad, g_grad))
        n, c_box, c_score = detection_errors(f"{kind} CPU vs float64", w_dets, c_dets)
        _, g_box, g_score = detection_errors(f"{kind} card vs float64", w_dets, g_dets)
        if g_box > witness_limit("box", c_box) or g_score > witness_limit("score", c_score):
            raise AssertionError(f"{kind} reference: card boxes {g_box:.3e} px, scores {g_score:.3e} from float64 "
                                 f"(the CPU's {c_box:.3e}, {c_score:.3e})")
        clip = ""
        if kind == "resnet_d":
            lrs = sorted({g["lr"] for g in build_clip_optimizer(cfg, gpu).param_groups})
            clip = f"; the step's optimizer: build_clip_optimizer, group learning rates {lrs}"
        print(f"{kind} reference ({BACKBONE_NAMES[kind]}, card and CPU float32 against CPU float64, narrow): "
              + "; ".join(lines) + f"; eval {n} valid detections, boxes card {g_box:.3e} px CPU {c_box:.3e}, scores "
              f"card {g_score:.3e} CPU {c_score:.3e}; K2/K3 a step {g_step[0]}/{g_step[1]}, K2 an eval "
              f"{g_eval[1]}{clip} {tag}")
    if rotated:
        rroi_reference_check(tag)


# phase 45's canvases: TEST.AUG.MIN_SIZES' nine short sides on a 480x640 image
# (400x533 ... 1200x1600), each rounded up to a multiple of 32; the default
# PAD.CANVAS_BUCKETS hold none past 1008 wide, where the mapper raises, as JAX's
TTA_BUCKETS = [[416, 544], [512, 672], [608, 800], [704, 960], [800, 1088], [928, 1216], [1024, 1344],
               [1120, 1472], [1216, 1600]]


def tta_path(tag, kernels):
    """Phase 45: ``GeneralizedRCNNWithTTA`` around phase 4's R-101-FPN with
    POOLER_IMPL auto (bf16, seeded damped weights, score threshold 0.001) on
    a seeded 480x640 image: TEST.AUG's defaults, 9 scales x 2 flips = 18
    variants on ``TTA_BUCKETS``. A warm-up call, then 3 timed calls with
    every count set to 0 just before and read just after (K2 18 times a
    call); the variants' forwards and the merge timed apart; each identity
    variant against the plain eval forward on its canvas and the card's
    merge against the host's, bit for bit; then ``tta_reference_check``."""
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.modeling.test_time_augmentation import (
        GeneralizedRCNNWithTTA, _boxes_to_original, merge_tta_detections,
    )
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.utils.init import damped_init

    cfg = serving_cfg("auto")
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.001
    cfg.PAD.CANVAS_BUCKETS = TTA_BUCKETS
    model = damped_init(build_model(cfg), seed=0)
    image = (np.random.RandomState(0).rand(480, 640, 3) * 255).astype(np.uint8)
    tta = GeneralizedRCNNWithTTA(cfg, model)
    variants = tta.tta_mapper(image)
    if len(variants) != 18:
        raise AssertionError(f"TTA: {len(variants)} variants, want 18")
    tta(image)  # warm-up: every canvas once
    torch.cuda.synchronize()
    ra.roi_align_band.launches = ra.roi_align_paired.launches = 0
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        boxes, scores, classes, ok = tta(image)  # numpy: synchronised
    ms = (time.perf_counter() - t0) * 1e3 / iters
    n = ra.roi_align_band.launches, ra.roi_align_paired.launches
    if n != (0, 18 * iters):
        raise AssertionError(f"TTA: K1/K2 launches {n} over {iters} calls, want (0, {18 * iters})")
    add_launches(kernels, "roi_align_paired", n[1])
    if boxes.shape != (100, 4) or not np.isfinite(boxes).all() or not ok.any():
        raise AssertionError(f"TTA: merged boxes {boxes.shape}, {int(ok.sum())} kept")

    t0 = time.perf_counter()
    (vb, vs, vc, vv), device = tta.variant_detections(image)
    t1 = time.perf_counter()
    merged = merge_tta_detections(*(torch.from_numpy(x).to(device) for x in (vb, vs, vc, vv)),
                                  tta.nms_thresh, tta.topk)
    merged = [t.cpu() for t in merged]
    t2 = time.perf_counter()
    host = merge_tta_detections(*(torch.from_numpy(x) for x in (vb, vs, vc, vv)), tta.nms_thresh, tta.topk)
    for name, a, b in zip(("boxes", "scores", "classes", "ok"), merged, host):
        if not torch.equal(a, b):
            raise AssertionError(f"TTA: the card's merge differs from the host's in {name}")
    D = cfg.TEST.DETECTIONS_PER_IMAGE
    scale_ms = []
    for i, v in enumerate(variants):
        if v["tta_flip"]:
            continue
        batch = {"image": torch.from_numpy(v["image"][None]).to(device),
                 "image_size": torch.from_numpy(v["image_size"][None]).to(device)}
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        dets = model(batch)
        torch.cuda.synchronize()
        scale_ms.append(f"{int(v['image_size'][0])}: {(time.perf_counter() - s0) * 1e3:.1f}")
        rows = slice(i * D, (i + 1) * D)
        same = (np.array_equal(vb[rows], _boxes_to_original(dets.boxes[0].cpu().numpy(), v["tta_scale"], False,
                                                            v["tta_width"]))
                and np.array_equal(vs[rows], dets.scores[0].cpu().numpy())
                and np.array_equal(vc[rows], dets.classes[0].cpu().numpy())
                and np.array_equal(vv[rows], dets.valid[0].cpu().numpy()))
        if not same:
            raise AssertionError(f"TTA: identity variant at {tuple(v['image_size'])} differs from the plain forward")
    print(f"tta: R-101-FPN bf16 auto, 1 image 480x640, 18 variants (9 scales 400-1200 x flip, canvases "
          f"{TTA_BUCKETS[0]}..{TTA_BUCKETS[-1]}): {ms:.2f} ms an image, K1/K2 {n[0]}/{n[1]} over {iters} calls; "
          f"variants {(t1 - t0) * 1e3:.2f} ms, merge {(t2 - t1) * 1e3:.2f} ms (share "
          f"{(t2 - t1) / (t2 - t0):.4f}); {int(vv.sum())} variant detections -> {int(ok.sum())} kept; identity "
          f"variants equal to the plain forward and the card's merge to the host's, bit for bit {tag}")
    print(f"tta: one identity variant's forward (B=1, from a copied canvas), ms by short side: "
          f"{', '.join(scale_ms)} {tag}")
    del model
    torch.cuda.empty_cache()
    tta_reference_check(tag)


def tta_reference_check(tag):
    """The narrow R-50-FPN (``calibrated_init``, float32, POOLER_IMPL auto)
    through TTA on a seeded 96x128 image (scales 96, 128 and 160 x flip on
    one 160x224 canvas): the card's and the CPU's merged detections each
    against a float64 witness of the same weights on the CPU, the card
    within ``witness_limit`` of the CPU's distance; kept slots and classes
    equal."""
    import numpy as np
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.modeling.test_time_augmentation import GeneralizedRCNNWithTTA

    cfg = narrow_cfg("auto")
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 100
    cfg.TEST.DETECTIONS_PER_IMAGE = 30
    cfg.TEST.AUG.MIN_SIZES = (96, 128, 160)
    cfg.PAD.CANVAS_BUCKETS = [[160, 224]]
    image = (np.random.RandomState(5).rand(96, 128, 3) * 255).astype(np.uint8)
    cpu = build_model(cfg, device="cpu")
    calibrated_init(cpu, seed=0)
    card = build_model(cfg)
    card.load_state_dict(cpu.state_dict())
    wit = build_model(cfg, device="cpu").double()
    wit.load_state_dict(cpu.state_dict())
    wit.compute_dtype = torch.float64

    def witness(batch):
        with float64_witness():
            return wit({"image": torch.from_numpy(batch["image"]).double(), "image_size": batch["image_size"]})

    out = {}
    for key, fn in (("card", card), ("cpu", cpu), ("witness", witness)):
        out[key] = GeneralizedRCNNWithTTA(cfg, fn)(image)
    ref = out["witness"]
    ok = ref[3]
    errs = {}
    for key in ("card", "cpu"):
        b, s, c, k = out[key]
        if not np.array_equal(k, ok) or not np.array_equal(c[ok], ref[2][ok]) or int(ok.sum()) < 10:
            raise AssertionError(f"TTA reference: the {key}'s kept slots or classes differ from the witness's")
        errs[key] = (float(np.abs(b[ok].astype(np.float64) - ref[0][ok]).max()),
                     float(np.abs(s[ok].astype(np.float64) - ref[1][ok]).max()))
    (cb, cs), (pb, ps) = errs["card"], errs["cpu"]
    if cb > witness_limit("box", pb) or cs > witness_limit("score", ps):
        raise AssertionError(f"TTA reference: card box/score err {cb:.3e}/{cs:.3e} against the CPU's {pb:.3e}/{ps:.3e}")
    print(f"tta reference: narrow R-50-FPN float32 auto, 6 variants, {int(ok.sum())} kept; from the float64 witness "
          f"box err card {cb:.3e} CPU {pb:.3e} (limit {witness_limit('box', pb):.1e}), score err card {cs:.3e} CPU "
          f"{ps:.3e} (limit {witness_limit('score', ps):.1e}) {tag}")


def exported_equal(what, got, want):
    """An exported program's outputs against the eager call's: bit for bit,
    or else within 1e-3 px and 1e-4 with classes and validity equal (the
    fields that differ are named). Returns a description."""
    import torch

    if isinstance(want, torch.Tensor):
        got, want = {"out": got}, {"out": want}
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if not differ:
        return "equal bit for bit"
    if "valid" in want:
        v = want["valid"]
        if not torch.equal(got["valid"], v) or not torch.equal(got["classes"][v], want["classes"][v]):
            raise AssertionError(f"{what}: validity or classes differ from the eager forward")
        box = float((got["boxes"][v].double() - want["boxes"][v].double()).abs().max())
        score = float((got["scores"][v].double() - want["scores"][v].double()).abs().max())
        if box > 1e-3 or score > 1e-4:
            raise AssertionError(f"{what}: {differ} differ from the eager forward, box {box:.3e} score {score:.3e}")
        return f"{differ} differ: box {box:.3e} px (tol 1e-3), score {score:.3e} (tol 1e-4)"
    raise AssertionError(f"{what}: {differ} differ from the eager call")


def export_layout(program, batch):
    """The layout of a loaded program's hand-kernel ops: one run of its graph
    on ``batch`` through ``torch.fx.Interpreter``, holding each node's real
    output strides against those of the fake tensor the trace recorded.
    Returns the count of tensor nodes, of those whose strides differ (with
    up to 5 of their ops), of the copies (``aten.clone``, ``contiguous``)
    that feed a ``lvc_tpu_torch`` op, of the copies whose real input already
    had the real output's strides (a copy an eager run skips: the trace
    recorded it for a fake layout; up to 5 named), each op's tensor inputs
    as (fake, real) strides where they differ, and the graph's copying nodes
    by op."""
    import torch
    import torch.utils._pytree as pytree

    def strides(v):
        return tuple(v.stride()) if isinstance(v, torch.Tensor) and v.layout == torch.strided else None

    ops = [n for n in program.graph.nodes if n.op == "call_function" and str(n.target).startswith("lvc_tpu_torch.")]
    copies = sum(1 for n in ops for a in pytree.tree_leaves(n.args)
                 if isinstance(a, torch.fx.Node) and str(a.target).split(".")[1:2] in (["clone"], ["contiguous"]))
    copy_ops = {}
    for n in program.graph.nodes:
        if n.op == "call_function" and any(w in str(n.target) for w in ("clone", "copy", "contiguous")):
            copy_ops[str(n.target)] = copy_ops.get(str(n.target), 0) + 1
    seen = dict(nodes=0, differ=0, first=[], copies_into_ops=copies, needless_copies=0, needless=[], op_inputs=[],
                copy_ops=copy_ops)

    class Run(torch.fx.Interpreter):
        def run_node(self, n):
            out = super().run_node(n)
            fake = n.meta.get("val")
            if strides(out) is not None and strides(fake) is not None:
                seen["nodes"] += 1
                if strides(out) != strides(fake) and out.numel() > 1:
                    seen["differ"] += 1
                    if len(seen["first"]) < 5:
                        seen["first"].append(f"{n.target} {tuple(out.shape)}: fake {strides(fake)}, "
                                             f"real {strides(out)}")
            if str(n.target).split(".")[1:2] in (["clone"], ["contiguous"]) and isinstance(n.args[0], torch.fx.Node):
                src = n.args[0]
                if strides(self.env[src]) == strides(out):
                    seen["needless_copies"] += 1
                    if len(seen["needless"]) < 5:
                        seen["needless"].append(f"{n.target} of {src.target} {tuple(out.shape)}")
            if n in ops:
                for a in pytree.tree_leaves(n.args):
                    if isinstance(a, torch.fx.Node) and strides(self.env[a]) != strides(a.meta.get("val")):
                        seen["op_inputs"].append(f"{n.target} <- {a.target}: fake {strides(a.meta.get('val'))}, "
                                                 f"real {strides(self.env[a])}")
            return out

    with torch.no_grad():
        Run(program).run(*pytree.tree_leaves(batch))
    return seen


def export_path(tag, kernels):
    """Phase 46: ``lvc_tpu_torch.export`` on the card. Phase 4's serving
    forward (R-101-FPN bf16 pallas_fast, B=8 at 832x1344, seeded damped
    weights), DINO ViT-S/8 bf16 at B=64 and one fused GEMM call (the R-101's
    res4 conv3 shape) are exported, saved to a .pt2, loaded and run: a
    warm-up, then 3 timed calls of the eager model and of the loaded
    program, every count set to 0 just before and read just after each (K1
    once a forward, the attention 12 times, the fused GEMM once), and one
    profiled R-101 forward of each; outputs against the eager calls'
    (``exported_equal``)."""
    import torch

    from lvc_tpu_torch.export import export_model, load_exported, save_exported
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.ops import fused_matmul
    from lvc_tpu_torch.ops import roi_align as ra
    from lvc_tpu_torch.ops.attention import flash_attention
    from lvc_tpu_torch.pipeline.verification import build_dino
    from lvc_tpu_torch.utils.init import damped_init

    def fused(x, w, scale, shift, res):
        return fused_matmul.conv1x1_affine_residual(x, w, scale, shift, res)

    class Fused(torch.nn.Module):
        def forward(self, args):
            return fused(*args)

    g = torch.Generator(device="cuda").manual_seed(0)
    M, K, N = 8 * 52 * 84, 256, 1024
    fused_args = (torch.randn(8, 52, 84, K, generator=g, device="cuda").to(torch.bfloat16),
                  (torch.randn(N, K, generator=g, device="cuda") * K ** -0.5).to(torch.bfloat16).t(),
                  torch.rand(N, generator=g, device="cuda") + 0.5, torch.randn(N, generator=g, device="cuda"),
                  torch.randn(8, 52, 84, N, generator=g, device="cuda").to(torch.bfloat16))
    crops = torch.randn(64, 224, 224, 3, generator=g, device="cuda")
    cases = (
        ("R-101-FPN serving bf16 pallas_fast B=8 832x1344", lambda: damped_init(build_model(serving_cfg("pallas_fast")),
                                                                               seed=0),
         serving_batch(8), {"roi_align_band": (ra.roi_align_band, 1)}),
        ("DINO ViT-S/8 bf16 B=64", lambda: build_dino("dino_vits8", compute_dtype=torch.bfloat16), crops,
         {"flash_attention_fwd": (flash_attention, 12)}),
        (f"fused GEMM ({M} x {K} x {N}, bf16)", Fused, fused_args,
         {"matmul_affine_residual": (fused_matmul.matmul_affine_residual, 1)}),
    )
    iters = 3
    with tempfile.TemporaryDirectory() as tmp:
        for what, make, batch, counted in cases:
            model = make()
            t0 = time.perf_counter()
            ep = export_model(model, batch)
            t1 = time.perf_counter()
            path = os.path.join(tmp, "program.pt2")
            save_exported(ep, path)
            t2 = time.perf_counter()
            program = load_exported(path).module()
            t3 = time.perf_counter()
            times, launched = {}, {}
            with torch.no_grad():
                for key, fn in (("eager", model), ("exported", program)):
                    out = fn(batch)  # warm-up
                    torch.cuda.synchronize()
                    for wrapper, _ in counted.values():
                        wrapper.launches = 0
                    ra.roi_align_paired.launches = 0
                    s0 = time.perf_counter()
                    for _ in range(iters):
                        out = fn(batch)
                    torch.cuda.synchronize()
                    times[key] = (time.perf_counter() - s0) * 1e3 / iters
                    launched[key] = {name: w.launches for name, (w, _) in counted.items()}
                    if ra.roi_align_paired.launches:
                        raise AssertionError(f"export {what} {key}: K2 launched")
                    for name, (w, per_call) in counted.items():
                        if w.launches != per_call * iters:
                            raise AssertionError(f"export {what} {key}: {name} launched {w.launches} times, "
                                                 f"want {per_call * iters}")
                    if what.startswith("R-101"):
                        profile_call(lambda: fn(batch), times[key], f"{key} R-101 serving forward", tag)
                    if key == "eager":
                        want = out._asdict() if hasattr(out, "_asdict") else out
                        if isinstance(want, dict):
                            want = {k: v for k, v in want.items() if v is not None}
                got = out
            verdict = exported_equal(f"export {what}", got, want)
            for name in counted:
                add_launches(kernels, name, launched["exported"][name])
            layout = export_layout(program, batch)
            if layout["copies_into_ops"]:
                raise AssertionError(f"export {what}: {layout['copies_into_ops']} copies feed the hand-kernel ops")
            print(f"export {what}: graph layout, {layout['nodes']} tensor nodes, the trace's fake strides differ "
                  f"from the run's at {layout['differ']} {layout['first']}; copies feeding the hand-kernel ops "
                  f"{layout['copies_into_ops']}; copies of tensors already in the copy's layout "
                  f"{layout['needless_copies']} {layout['needless']}; copying nodes {layout['copy_ops']}; "
                  f"op inputs whose fake strides differ {layout['op_inputs']} {tag}")
            print(f"export {what}: export {t1 - t0:.1f} s, save {t2 - t1:.1f} s ({os.path.getsize(path) / 2 ** 20:.1f} "
                  f"MiB), load {t3 - t2:.1f} s; loaded program {times['exported']:.2f} ms against eager "
                  f"{times['eager']:.2f} ms a call; launches from the loaded program {launched['exported']} over "
                  f"{iters} calls; outputs {verdict} {tag}")
            del model, ep, program
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# BatchNorm, SyncBN and PreciseBN: detectron2's SyncBN Mask R-CNN (phases 47-48)
# ---------------------------------------------------------------------------

SYNCBN_ITERS = 8  # phase 47's training run: PreciseBN refreshes after iteration 4 and after the last
SYNCBN_BN_ITERS = 4  # TEST.PRECISE_BN.NUM_ITER, cut from the yaml's 200
SYNCBN_DATASET = "syncbn_mini_coco"  # write_mini_coco's instances under all 80 classes, with no few-shot merge


def bn_stats(model):
    """Every FrozenBN and SyncBN running statistic of ``model``, cloned."""
    return {k: v.detach().clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def replay_refresh(old, n: int, momentum: float = 0.9):
    """The JAX package's refresh (``update_bn_stats``) on statistics that its
    batches leave unchanged, in float32 on the CPU: ``(old - m * old) / (1 -
    m)`` summed ``n`` times, over ``n``, each operation IEEE's."""
    import torch

    out = {}
    for k, v in old.items():
        v = v.cpu()
        m, keep = torch.tensor(momentum, dtype=torch.float32), torch.tensor(1.0 - momentum, dtype=torch.float32)
        raw = (v - m * v) / keep
        acc = raw
        for _ in range(n - 1):
            acc = acc + raw
        out[k] = acc / torch.tensor(float(n), dtype=torch.float32)
    return out


def fused_launches_check(model, batch, what):
    """One forward of ``model`` with ``LVC_TPU_FUSED_RESIDUAL=1``: no SyncBN
    conv fuses (as in JAX, only FrozenBN and bias-only 1x1 convs do), so the
    fused GEMM must not launch. Returns the count (0)."""
    import torch

    from lvc_tpu_torch.modeling.layers import fused_residual
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual

    before = matmul_affine_residual.launches
    with fused_residual(True), torch.no_grad():
        model(batch)
    torch.cuda.synchronize()
    n = matmul_affine_residual.launches - before
    if n:
        raise AssertionError(f"{what}: the fused GEMM launched {n} times on a SyncBN model")
    return n


def syncbn_train_net(tag, kernels):
    """Phase 47b: ``train_net.main`` in this process on ``task_cfg("syncbn")``
    (AMP, POOLER_IMPL pallas_train, IMS_PER_BATCH 16) over ``write_mini_coco``'s
    six 160x200 images (``SYNCBN_DATASET``, 80 classes; the loader resizes
    them to 640-800 short sides), ``SYNCBN_ITERS`` iterations with
    ``TEST.EVAL_PERIOD`` half of them, so PreciseBN refreshes once mid-run and
    once after the last, from ``SYNCBN_BN_ITERS`` loader batches each. The
    trainer's ``_materialize`` gives damped weights and ``seed_syncbn``'s
    statistics (a detectron2 ``.pth`` in MODEL.WEIGHTS would not fill SyncBN
    norms, as in JAX). Checks: the statistics bit-unchanged by every step;
    after each refresh equal to ``replay_refresh`` of the statistics before
    it (the card's arithmetic against the CPU's, bit for bit); the fused GEMM
    0 launches; every loss finite; K2/K3 1/1 an iteration; the run's last
    checkpoint loads whole (``syncbn_checkpoint_check``). Reports ms/iter,
    data_time, peak memory, each refresh's seconds, and one more step
    recorded (``recorded_train_pool``)."""
    import torch

    from lvc_tpu_torch.data.builtin_meta import _get_builtin_metadata
    from lvc_tpu_torch.data.catalog import DatasetCatalog
    from lvc_tpu_torch.data.meta_coco import register_meta_coco
    from lvc_tpu_torch.engine import hooks
    from lvc_tpu_torch.ops.fused_matmul import matmul_affine_residual
    from lvc_tpu_torch.tools import train_net
    from lvc_tpu_torch.utils.init import damped_init

    refreshes, held = [], {}
    update_bn_stats = hooks.update_bn_stats

    def checked_refresh(model, batches, momentum=0.9):
        old = bn_stats(model)
        changed = [k for k, v in old.items() if not torch.equal(v, held["stats"][k])]
        if changed:
            raise AssertionError(f"syncbn train_net: the steps moved {len(changed)} statistics ({changed[0]})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = update_bn_stats(model, batches, momentum)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        new = bn_stats(model)
        want = replay_refresh(old, n, momentum)
        off = [k for k in new if not torch.equal(new[k].cpu(), want[k])]
        if n != SYNCBN_BN_ITERS or off:
            raise AssertionError(f"syncbn train_net: a refresh of {n} batches; {len(off)} statistics differ from "
                                 f"the CPU's float32 replay")
        moved = sum(int((new[k] != old[k]).sum()) for k in new)
        refreshes.append((secs, moved, sum(v.numel() for v in new.values())))
        held["stats"] = new
        return n

    class SyncBNTrainer(train_net.Trainer):
        def _materialize(self, model, seed):
            seed_syncbn(damped_init(model, seed), seed)
            held["stats"] = bn_stats(model)

    saved = train_net.Trainer
    train_net.Trainer, hooks.update_bn_stats = SyncBNTrainer, checked_refresh
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "datasets")
            write_mini_coco(root, seed=0)
            if SYNCBN_DATASET in DatasetCatalog:
                DatasetCatalog.remove(SYNCBN_DATASET)
            register_meta_coco(SYNCBN_DATASET, _get_builtin_metadata("coco_fewshot"),
                               os.path.join(root, "coco", "trainval2014"),
                               os.path.join(root, "cocosplit", "datasplit", "trainvalno5k.json"))
            opts = [str(x) for x in syncbn_opts()] + [
                "MODEL.ROI_HEADS.POOLER_IMPL", "pallas_train", "SOLVER.IMS_PER_BATCH", "16", "SOLVER.MAX_ITER",
                str(SYNCBN_ITERS), "SOLVER.AMP.ENABLED", "True", "SOLVER.CHECKPOINT_PERIOD", "100000",
                "DATASETS.TRAIN", f"('{SYNCBN_DATASET}',)", "DATASETS.TEST", "()", "TEST.EVAL_PERIOD",
                str(SYNCBN_ITERS // 2), "TEST.PRECISE_BN.NUM_ITER", str(SYNCBN_BN_ITERS), "SEED", "0",
                "OUTPUT_DIR", os.path.join(tmp, "out")]
            fused = matmul_affine_residual.launches
            torch.cuda.reset_peak_memory_stats()
            _, secs, n, trainer = run_cli(train_net, ["--config-file", BASE_YAML] + opts)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            fused = matmul_affine_residual.launches - fused
            hist = trainer.storage.histories()
            losses = [v for k, h in hist.items() if k.startswith("loss") for v in h.values()]
            names = [type(h).__name__ for h in trainer._hooks]
            if len(trainer.step_s) != SYNCBN_ITERS or set(trainer.step_launches) != {(1, 1)} or fused or \
                    len(refreshes) != 2 or not losses or not all(math.isfinite(v) for v in losses) or \
                    names[1:4] != ["LRSchedulerHook", "PreciseBN", "PeriodicCheckpointerHook"]:
                raise AssertionError(f"syncbn train_net: {len(trainer.step_s)} steps, K2/K3 per iteration "
                                     f"{sorted(set(trainer.step_launches))}, fused GEMM {fused}, {len(refreshes)} "
                                     f"refreshes, hooks {names}")
            ms = train_net_report(f"syncbn train_net: {TASK_NAMES['syncbn']} 80 classes AMP, IMS_PER_BATCH 16 on the "
                                  f"mini COCO tree (TF32 convolutions)", trainer, secs, peak, 16, tag)
            print(f"syncbn train_net: PreciseBN after iterations {SYNCBN_ITERS // 2} and {SYNCBN_ITERS}, "
                  f"{SYNCBN_BN_ITERS} batches of 16 each (float32, the build dtype): "
                  + "; ".join(f"{t:.3f} s, {m} of {c} statistics moved by the EMA inversion's rounding"
                              for t, m, c in refreshes)
                  + f"; every statistic bit-unchanged by the {SYNCBN_ITERS} steps and, after each refresh, equal "
                  f"bit for bit to the CPU's float32 replay of JAX's arithmetic; fused GEMM launches {fused}; hooks "
                  f"{names} {tag}")
            syncbn_checkpoint_check(trainer, tag)
            recorded_train_pool("syncbn train_net step (16 x 512 slots, AMP)", trainer, kernels, tag)
            kernels["roi_align_paired"]["launches"] += n[1]
            kernels["roi_align_paired_bwd"]["launches"] += n[2]
            del trainer
    finally:
        train_net.Trainer, hooks.update_bn_stats = saved, update_bn_stats
        torch.cuda.empty_cache()
    return ms, refreshes


def syncbn_checkpoint_check(trainer, tag):
    """The trained SyncBN model's last checkpoint loaded through
    ``MODEL.WEIGHTS`` into a new model, as ``train_net --eval-only`` loads it:
    every entry, each SyncBN weight, bias and statistic among them, bit-equal
    to the trained model's."""
    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.modeling.layers import SyncBatchNorm

    path = trainer.checkpointer.get_checkpoint_file()
    t0 = time.perf_counter()
    model = type(trainer).build_model(trainer.cfg)
    DetectionCheckpointer(model).load(path)
    secs = time.perf_counter() - t0
    want, got = trainer.model.state_dict(), model.state_dict()
    off = [k for k, v in want.items() if not torch.equal(got[k], v)]
    n_sync = sum(isinstance(m, SyncBatchNorm) for m in model.modules())
    print(f"syncbn checkpoint: {os.path.basename(path)} loaded through MODEL.WEIGHTS into a new model in {secs:.2f} s; "
          f"{len(want) - len(off)} of {len(want)} entries bit-equal to the trained model's, {n_sync} SyncBN norms "
          f"{tag}")
    if off or not n_sync:
        raise AssertionError(f"syncbn checkpoint: {len(off)} entries differ from the trained model's ({off[:3]})")
    del model


def syncbn_path(tag, kernels):
    """Phase 47: detectron2's SyncBN Mask R-CNN at full width
    (``task_cfg("syncbn")``, Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml): bf16
    serving at B=8 with pallas_fast and auto (``task_serving``; the FPN
    levels are float32, as JAX's BN promotes, so K1 and K2 run their float32
    instantiation), one more forward with the fused path on (0 launches of
    the fused GEMM), then ``syncbn_train_net``."""
    import torch

    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.utils.init import damped_init

    with cli_tf32():
        task_serving("syncbn", kernels, tag)
        cfg = task_cfg("syncbn", "auto")
        cfg.MODEL.DTYPE = "bfloat16"
        model = seed_syncbn(damped_init(build_model(cfg), seed=0))
        feats = model.backbone_features(serving_batch(2))
        dtypes = sorted({str(v.dtype) for v in feats.values()})
        n = fused_launches_check(model, serving_batch(2), "syncbn serving")
        print(f"syncbn serving: bf16 forward with LVC_TPU_FUSED_RESIDUAL=1: fused GEMM launches {n}; FPN levels "
              f"{dtypes} (BN promotes, as in JAX) {tag}")
        if dtypes != ["torch.float32"]:
            raise AssertionError(f"syncbn serving: FPN levels {dtypes}, want float32")
        del model, feats
        torch.cuda.empty_cache()
        syncbn_train_net(tag, kernels)


def syncbn_reference_phase(tag):
    """Phase 48: ``task_reference_check`` on the narrow SyncBN Mask R-CNN
    (``task_reference_cfg("syncbn")``, seeded statistics): card and CPU
    float32 against their float64 witnesses."""
    task_reference_check(tag, kinds=("syncbn",))


def tf32_off():
    """Float32 convolutions and matmuls without TF32, in this process (the
    script's own and each rank it spawns: cuDNN allows TF32 by default)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


FT_NOVEL_YAML = "configs/COCO-detection/faster_rcnn_R_50_FPN_ft_novel_30shot.yaml"
# the checkpoints a phase hands to later ones: (file, the phase writing it, the config of a damped-init stand-in)
HANDOFFS = {"base": ("base.pth", 17, TRAIN_NET_YAML), "gate": ("gate.pth", 18, None),
            "ubbr": ("ubbr.pth", 20, UBBR_YAML), "ft_novel": ("ft_novel.pth", 22, FT_NOVEL_YAML)}
# phases that need another phase's run (its kernels entry, its time or its trained model), added when not selected
REQUIRES = {4: (2,), 7: (2, 5), 10: (8,), 14: (4, 12), 15: (7, 12), 28: (18,), 45: (2,), 46: (2, 8, 12), 47: (2, 5)}
FUSED_PHASES = (12, 13, 14, 15)  # the rest run with the fused path off, whatever the environment says


def handoff(run, key: str) -> str:
    """The path of a checkpoint one phase hands to later ones. When the phase
    that writes it is not selected, a damped-init checkpoint of its config
    stands in (the gate model has none: its phase is added instead)."""
    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.utils.init import damped_init

    name, phase, yaml = HANDOFFS[key]
    path = os.path.join(run["keep"], name)
    if phase not in run["selected"] and not os.path.exists(path):
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(REPO, yaml))
        model = damped_init(build_model(cfg), seed=0)
        shutil.copy(DetectionCheckpointer(model, os.path.join(run["keep"], "standin")).save(key, 0), path)
        print(f"{name}: a damped-init {yaml} stands in for phase {phase}'s checkpoint")
    return path


def coco_root(run) -> str:
    """Phases 30-31's seeded COCO tree (``coco_tree_for``), written once."""
    if "root" not in run:
        run["root"] = os.path.join(run["keep"], "datasets")
        coco_tree_for(run["root"])
    return run["root"]


def context_phases(run):
    tag = run["tag"]
    context_path(tag, handoff(run, "base"))
    crops_path(tag, handoff(run, "base"))
    context_reference_check(tag)
    precomputed_proposals_check(tag)
    predictor_check(tag)
    clustering_check(tag)


def phase_table():
    """(number, function name, call on the run's state) for phases 2-48 in
    the order ``main`` runs them; phase 1 (the build) always runs."""
    def k(run):
        return run["kernels"]

    return [
        (2, "kernel_phase", lambda r: k(r).update(kernel_phase(r["tag"]))),
        (3, "reference_check", lambda r: reference_check(r["tag"])),
        (4, "main_path", lambda r: r.update(serving_ms=main_path(r["tag"], k(r)))),
        (5, "backward_kernel_phase", lambda r: k(r).update(roi_align_paired_bwd=backward_kernel_phase(r["tag"]))),
        (6, "train_reference_check", lambda r: train_reference_check(r["tag"])),
        (7, "train_main_path", lambda r: r.update(train=train_main_path(r["tag"], k(r)))),
        (8, "attention_kernel_phase", lambda r: k(r).update(flash_attention_fwd=attention_kernel_phase(r["tag"]))),
        (9, "verify_reference_check", lambda r: verify_reference_check(r["tag"])),
        (10, "verify_main_path", lambda r: verify_main_path(r["tag"], k(r))),
        (11, "cli_phase", lambda r: cli_phase(r["tag"])),
        (12, "fused_kernel_phase", lambda r: k(r).update(matmul_affine_residual=fused_kernel_phase(r["tag"]))),
        (13, "fused_reference_check", lambda r: fused_reference_check(r["tag"])),
        (14, "fused_main_path", lambda r: fused_main_path(r["tag"], k(r), r["serving_ms"])),
        (15, "fused_train_path", lambda r: fused_train_path(r["tag"], k(r), r["train"])),
        (16, "trainer_reference_check", lambda r: trainer_reference_check(r["tag"])),
        (17, "train_net_path", lambda r: train_net_path(r["tag"], os.path.join(r["keep"], "base.pth"))),
        (18, "synthetic_ap_gate", lambda r: synthetic_ap_gate(r["tag"], os.path.join(r["keep"], "gate.pth"))),
        (19, "corrector_reference_check", lambda r: corrector_reference_check(r["tag"])),
        (20, "correct_path", lambda r: correct_path(r["tag"], os.path.join(r["keep"], "ubbr.pth"))),
        (21, "finetune_reference_check", lambda r: finetune_reference_check(r["tag"])),
        (22, "lvc_chain_path", lambda r: lvc_chain_path(r["tag"], handoff(r, "base"), handoff(r, "ubbr"),
                                                         os.path.join(r["keep"], "ft_novel.pth"))),
        (23, "dp_reference_check", lambda r: dp_reference_check(r["tag"])),
        (24, "dp_train_net_path", lambda r: dp_train_net_path(r["tag"])),
        (25, "extra_heads_reference_check", lambda r: extra_heads_reference_check(r["tag"])),
        (26, "parallel_finetune_path", lambda r: parallel_finetune_path(r["tag"], handoff(r, "base"),
                                                                         handoff(r, "ft_novel"))),
        (27, "c4_path", lambda r: c4_path(r["tag"])),
        (28, "voc_gate_check", lambda r: voc_gate_check(r["tag"], os.path.join(r["keep"], "gate.pth"))),
        (29, "voc_path", lambda r: voc_path(r["tag"])),
        (30, "lvis_path", lambda r: lvis_path(r["tag"], coco_root(r), handoff(r, "base"))),
        (31, "context_phases", context_phases),
        (32, "mask_serving_path", lambda r: mask_serving_path(r["tag"], k(r))),
        (33, "mask_train_path", lambda r: mask_train_path(r["tag"], k(r))),
        (34, "keypoint_path", lambda r: keypoint_path(r["tag"], k(r))),
        (35, "task_heads_phase", lambda r: task_heads_phase(r["tag"])),
        (36, "retinanet_path", lambda r: retinanet_path(r["tag"], coco_root(r))),
        (37, "panoptic_path", lambda r: panoptic_path(r["tag"], k(r))),
        (38, "semantic_path", lambda r: semantic_path(r["tag"])),
        (39, "dense_reference_phase", lambda r: dense_reference_phase(r["tag"])),
        (40, "swin_path", lambda r: coco_root(r) and swin_path(r["tag"], k(r))),
        (41, "resnet_d_path", lambda r: resnet_d_path(r["tag"], k(r))),
        (42, "dcn_path", lambda r: dcn_path(r["tag"], k(r))),
        (43, "rroi_heads_path", lambda r: rroi_heads_path(r["tag"])),
        (44, "variant_reference_check", lambda r: variant_reference_check(r["tag"])),
        (45, "tta_path", lambda r: tta_path(r["tag"], k(r))),
        (46, "export_path", lambda r: export_path(r["tag"], k(r))),
        (47, "syncbn_path", lambda r: syncbn_path(r["tag"], k(r))),
        (48, "syncbn_reference_phase", lambda r: syncbn_reference_phase(r["tag"])),
    ]


def select_phases(spec):
    """``--phases``: numbers, ranges (``32-35``) or function names, comma
    separated; None selects every phase. Adds the phases a selected one
    needs (``REQUIRES``)."""
    table = phase_table()
    if spec is None:
        return {n for n, _, _ in table}
    names = {name: n for n, name, _ in table}
    chosen = set()
    for part in spec.replace(" ", "").split(","):
        if part in names:
            chosen.add(names[part])
        elif "-" in part:
            lo, hi = part.split("-")
            chosen.update(range(int(lo), int(hi) + 1))
        elif part:
            chosen.add(int(part))
    unknown = chosen - set(names.values())
    if unknown:
        raise SystemExit(f"chip_smoke: no phase {sorted(unknown)} (phases 2-{max(names.values())}; 1 always runs)")
    todo = list(chosen)
    while todo:
        for need in REQUIRES.get(todo.pop(), ()):
            if need not in chosen:
                chosen.add(need)
                todo.append(need)
    return chosen


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port on one GPU.")
    parser.add_argument("--phases", default=None, help="run only these phases after the build: numbers, ranges or "
                        "function names, comma separated (e.g. 32-35 or mask_serving_path); default all")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from lvc_tpu_torch.modeling.layers import fused_residual
        from lvc_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    selected = select_phases(args.phases)
    tf32_off()
    card = card_line()
    tag = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}; "
          f"TF32 off (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}); phases 1 and "
          f"{','.join(str(n) for n in sorted(selected))}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as ex:
        reports = list(ex.map(_build.build, _build.SOURCES))
    print(f"build: {len(_build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s {tag}")
    for report in reports:
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {line.strip()} {tag}")

    with tempfile.TemporaryDirectory() as keep:
        run = {"tag": tag, "kernels": {}, "keep": keep, "selected": selected}
        for number, name, call in phase_table():
            if number not in selected:
                continue
            t0 = time.perf_counter()
            with fused_residual(False) if number not in FUSED_PHASES else contextlib.nullcontext():
                call(run)
            print(f"phase {number} ({name}) took {time.perf_counter() - t0:.1f} s {tag}")
        kernels = run["kernels"]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
