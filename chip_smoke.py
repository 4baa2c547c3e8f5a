#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openset_rcnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

In order it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from openset_rcnn_tpu_torch/csrc with nvcc, all
     sources at once;
  3. roi_align (K1): the kernel against its plain PyTorch version at the
     serving shapes (B=8, R=4273 RoIs per image, C=256, bf16 P2-P5 of an
     832x1344 canvas), elementwise within atol 2e-5 + rtol 1e-5, and times both;
     times it again at the train_bf16 shapes (B=16, R=512);
  4. nms_keep (K4): the kernel against its plain version at B=8 x N=2000 and
     N=1000 (dense overlapping boxes, ~20% invalid) and on the known
     branch's class-offset shape (20 classes shifted apart, N=2000),
     exactly; times each (CUDA events) and each of its two passes (device
     time under torch.profiler);
  5. iou_match (K3): the fused IoU+matcher kernel against its plain version
     at the training shapes (B=4 and B=16, G=100 padded GT, R=93,093
     anchors of the 832x1344 bucket), with an image without valid GT, a
     zero-area GT, a duplicate GT row and integer coordinates that make IoUs
     tie: all four outputs exactly equal; at most two device operations per
     call; the wrapper's time (CUDA events) beside the device time per call
     (torch.profiler); then the launch floor: an empty kernel, back to back
     and under the profiler;
  6. roi_align_bwd (K2, f32 accumulators): against its plain version at
     B=4 and B=16 x 512 RoIs, C=256 on the 832x1344 pyramid, on uniform
     boxes and on boxes clustered around the GT, within
     1e-5 * max(1, max|want|) (the plain version sums in another order),
     two launches bitwise equal; prints both versions' distance from the
     same sums in f64; times each;
  6a. roi_align adaptive (K1's adaptive mode, sampling_ratio -1, the
     *_parity.yaml configs' grid): against its plain version at the serving
     shapes and at B=16, R=512, on boxes that take 1 sample a bin axis and
     the clip at 8, within atol 2e-5 + rtol 1e-5, timed beside the static
     grid's K1 on the same boxes; prints the widest axis table and the most
     bins of one RoI meeting one row or column on these boxes, from the
     plain model of the kernels' tables (at most 16 and 7 by construction);
  6b. roi_align_bwd adaptive (K2 f32's adaptive mode): as phase 6, on the
     adaptive grid, timed beside the static grid's K2 f32; prints the
     kernel's distance from the f64 sums beside the previous design's
     (PERF.md's figure, printed only) and the table widths as 6a;
  7. roi_align_window (K5): window-fit levels at the serving shapes, f32 and
     bf16 features, an eighth of the boxes wide and an eighth tall (aspect
     4.5 to 8.5); f32 within atol 2e-5 + rtol 1e-5, bf16 within one bf16
     step; prints how many RoIs the rule moved up a level;
  8. roi_align_bwd_bf16 (K2, pallas_bf16): bf16 accumulators at B=16 x 512
     RoIs, C=256, against the plain version (4 bf16 steps of the cell plus
     2^-7 of the largest) and against the f32 kernel (the JAX suite's band),
     two launches bitwise equal; on uniform boxes and on boxes clustered
     around 20 GT boxes per image (as the ROI sampler draws them), both
     timed; prints the accumulators' bytes;
  8a. frozen_bn_act (FrozenBN, residual and ReLU in one pass): the 49 calls
     of a bf16 ResNet-50 forward on one 832x1344 image, each bitwise its
     plain version; one frame's calls timed as a CUDA graph on the kernel
     and on the plain version, beside the bytes' bound;
  9. references: the serving path and one training step on the GPU against
     the same seeded model on the CPU (plain versions) on a 2x64x96 batch:
     f32 (configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml), bf16
     (configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml) and bf16 with
     TPU.ROI_ALIGN_IMPL pallas; then the parity config
     (configs/VOC-COCO/openset_rcnn_R50_FPN_128k_parity.yaml: f32, gather
     levels, the adaptive grid), serving and one training step; then the
     same two for the Swin-T and the ViT-B configs
     (configs/VOC-COCO/openset_rcnn_SwinT_FPN_128k.yaml, drop-path 0.2, with
     the CPU's drop-path masks handed to the GPU;
     configs/VOC-COCO/openset_rcnn_ViT_FPN_128k.yaml, norm clipping), each
     in f32 and with TPU.DTYPE bfloat16;
 10. serve: Predictor on the f32 config at 832x1344, batch 8, seeded random
     weights; warm-up (one eager call, one CUDA graph capture), then timed
     batches with CUDA events, each a graph replay that calls no kernel
     wrapper (the tracer's predict.* counters; its kernel.* counters stay 0), the
     replays' launches of K1 and K4 by the device trace (torch.profiler),
     the stage split, output checks, and the cascade with kernel NMS
     against the cascade with plain NMS;
 11. train: Trainer on the f32 config at 832x1344, batch 4, on the synthetic
     batch of bench.py (20 GT boxes per image); timed steps, the stage split,
     launch counts, finite losses, frozen parameters and buffers bitwise
     unchanged, trainable ones moved, one step under torch.profiler (device
     idle share, device time by kernel), and two steps from one state on
     one batch giving bitwise equal parameters (a gate); a trainable tensor
     that did not move fails the gate unless its last update lies below half
     an f32 step of every element; then train_remat: the f32 config with
     TPU.REMAT true, one step bitwise the step without remat from the same
     seeded state (a gate), timed steps and peak memory beside train's; then
     serve_swin and serve_vit (Predictor, batch 8, as serve) and train_swin
     (drop-path 0.2 active) and train_vit (norm clipping) (Trainer, batch 4,
     as train) on the two transformer configs; then train_parity, the same
     on the parity config (K1's and K2 f32's adaptive modes);
 12. serve_bf16: the same on the production bf16 config (batch 8);
 13. eval: the evaluation path, do_test, on the production bf16 config over
     44 seeded synthetic records (28 landscape 800x1200, 16 portrait
     1200x800, 2-6 GT boxes each over the VOC-COCO classes, known and
     unknown), decoded in memory and supplied through the transform's
     read_image: both buckets, three full landscape batches and a padded one
     of 4, two full portrait batches; Predictor's calls by the tracer's
     counters (per bucket one eager call and one capture, then replays) and
     K1's and K4's launches on the calls that ran their wrappers; the
     metric dict, eval img/s of the
     whole loop against Predictor-alone img/s, host ms per batch, the device
     idle share of one profiled pass, one eval batch under
     torch.cuda.set_sync_debug_mode("error"); then on the f32 config the
     fused cascade (K4) against the exact host cascade on every image that
     did not overflow, with equal VOC metric dicts, do_test with
     TPU.EVAL_FUSED false, and eval_type="proposals" over two batches;
     then parity_eval: do_test on the parity config over the same records
     (every batch through K1's adaptive mode and the host cascade);
 14. train_bf16: Trainer on the production config at batch 16 (its own
     IMS_PER_BATCH), with one profiled step;
 15. do_train: the training CLI, python -m openset_rcnn_tpu_torch.train,
     run in this process (its main) on the production config at batch 16
     on synthetic records written to a temporary directory (removed after
     the phase) and registered in the catalog, MODEL.WEIGHTS a port
     checkpoint of a seeded init with FrozenBN calibrated; MAX_ITER 6 with
     a checkpoint and an eval every 3, then --resume to 8; gates on finite
     losses, the metrics.json iterations (1, the eval at 3, 6; then 7, 8),
     the checkpoints (3, 6, 8), the resumed step (6) and K1, K2 bf16, K3
     and K4 launched; then --resume to 20 without evals, whose steady steps
     give the loop's img/s (beside Trainer.step alone) and whose last two
     steps, profiled, the device idle share (profiled, and their busy time
     against the unprofiled steps' span);
 16. weights: MODEL.WEIGHTS in the JAX package's formats on the production
     config: a seeded model with FrozenBN calibrated, written as a d2 .pth
     (fc1 permuted back to CHW), a caffe2 .pkl of its backbone (BN fused) and
     a JAX-layout .npz, each loaded through load_weights_file bitwise to its
     source; Predictor on the .pth bitwise Predictor on the state dict
     (batch 8, the capturing call: K1 1 and K4 2 launches); one Trainer step from the .pkl
     weights bitwise one from the same state dict (K3, K1, K2 bf16);
 17. predict: python -m openset_rcnn_tpu_torch.tools.predict (its main) with
     --viz on 8 synthetic 800x1200 JPEGs and the .pth: each JSON equal to
     Predictor + finalize_serve_image on the same pixels, overlays written,
     K1 and K4 launched; the CLI's img/s beside Predictor alone;
 18. export: python -m openset_rcnn_tpu_torch.tools.export_serving (its
     main) at batch 8 with the .pth, single program and --split, loaded
     back and run under entry_numerics on the serve batch: integers and
     masks exactly the live Predictor's, boxes and scores within
     tests/test_export_serving.py's tolerances; the loaded programs launch
     K1 and K4 (counted, and named by torch.profiler); sizes and ms/batch
     beside Predictor's. Phases 16-18 share a temporary directory, removed
     at the end.
 19. ddp_nccl: the training CLI with --num-gpus 1 --dist-url
     tcp://127.0.0.1:<free port>, in a process started here: an NCCL group
     of one, do_train under DistributedDataParallel on the production
     config at batch 16, 832x1344, 3 steps on 16 synthetic PNGs from a
     calibrated init; then the same command without --dist-url in this
     process (no group); the two final checkpoints bitwise equal (a gate);
     Trainer.step's ms inside each loop, and over 5 steps on bench.py's
     batch outside any loader, under DDP and without a group;
 20. ddp_gloo2: two gloo processes share the card (NCCL refuses two ranks
     on one card) and train the production config at global batch 16 (8 a
     rank) for 3 steps on bench.py's batch, against one process at batch
     16: each rank's sampling draws exactly its rows of one process's, the
     parameters within rtol 2e-3 / atol 2e-4; step 1's counts exactly, the
     other metrics within 1e-5 relative and every gradient tensor (after
     DDP's reduction) within 1e-3 of its largest, against one process
     computing the two ranks' shares at batch 8 each (cuDNN rounds a bf16
     batch of 8 otherwise than the same images inside 16: the drift is
     printed); step 1 against one process at batch 16 within that drift's
     limits (counts 1e-2, other metrics 1e-1 relative; the gradients'
     distance printed);
 21. tp_gloo: the f32 config with TPU.MESH_MODEL 2 (box_head fc1/fc2
     tensor-parallel) on 2 processes, then 2 x 2 on 4, at global batch 4
     for 2 steps against one process: the gates of phase 20 (step 1 and
     its gradients, the box head's shards gathered, against one process
     itself: the f32 drift is 0) and the gathered checkpoint's keys and
     shapes equal to one process's;
 22. eval_gloo2: do_test on two processes over phase 13's 44 records
     (records i::2 on rank i), on the f32 config and on the production
     config: every image's detections
     exactly one process's in f32, and in bf16 exactly those of one process
     inferring each rank's records alone (the same batches; cuDNN rounds a
     bf16 image by its place in the batch).
     Phases 19-22 share a temporary directory, removed at the end; rank 0
     of each returns its launch counts to this script.
Each path is driven with every launch count at 0 just before it and read
just after. The entry points set their own numerics (no TF32, no bf16
reduced-precision reductions; deterministic cuDNN in the train step): the
script leaves PyTorch's process-wide defaults alone, prints the flags a
stage's mark callback observes inside a serve batch and a train step, and
checks that two train steps from one state on one batch give bitwise equal
parameters (train and train_bf16). Then it prints one JSON line of kernel
figures and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises. Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result.

    python3 chip_smoke.py --timings [ROOT]

times only K1 and K4 at the shapes of phases 3 and 4, K1's adaptive mode at
phase 6a's serving shapes, and K3 and K2 f32 (static and adaptive) at those
of phases 5 and 6 (event and device time, no gates; K1 and K4 also after a
profiler session), with the openset_rcnn_tpu_torch package of ROOT (default:
this checkout), so that two versions of the kernels are timed by one script
in one call: run it on a checkout of each.

    python3 chip_smoke.py --step-timings [ROOT]

times only the train (f32, batch 4) and train_bf16 (batch 16) steps with
ROOT's package, with TF32 and bf16 reduced-precision reductions turned off
process-wide as this script did before the entry points set them, and
prints the device time by kernel of one profiled f32 step and whether two
steps repeat bitwise (no gates): run it on a checkout of each version.
"""
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml"
CONFIG_BF16 = ROOT / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml"  # the production config
# f32, gather levels, the adaptive grid, the host cascade
CONFIG_PARITY = ROOT / "configs/VOC-COCO/openset_rcnn_R50_FPN_128k_parity.yaml"
CONFIG_SWIN = ROOT / "configs/VOC-COCO/openset_rcnn_SwinT_FPN_128k.yaml"  # Swin-T, drop-path 0.2
CONFIG_VIT = ROOT / "configs/VOC-COCO/openset_rcnn_ViT_FPN_128k.yaml"    # ViT-B, norm clipping
BATCH = 8
BUCKET = (832, 1344)
STRIDES = (4, 8, 16, 32)
ATOL, RTOL = 2e-5, 1e-5  # RoIAlign kernel vs plain, elementwise
# NVIDIA H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
ROI_FLOPS_PER_OUTPUT = 4 * 8 + 1  # per sample: 4 mul + 3 add + 1 accumulate; then the mean
IOU_FLOPS = 15                    # one IoU test of the greedy scan or the matcher
ROI_BWD_FLOPS_PER_SAMPLE = 4 * 2  # per sample and channel: 4 neighbours x (weight mul + add)
SERVE_WARMUP, SERVE_BATCHES = 2, 5
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
TRAIN_BATCH = 4                   # SOLVER.IMS_PER_BATCH of the config
TRAIN_BATCH_BF16 = 16             # SOLVER.IMS_PER_BATCH of the production config
TRAIN_ROIS = 512                  # MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
BWD_TOL = 1e-5                    # RoIAlign backward kernel vs plain, scaled by max(1, max|want|)
# bf16 accumulators, kernel vs plain: both round each RoI's f32 window sum
# into its cells once, RoI after RoI in index order, but the kernel sums the
# window in the TPU kernel's separable order and the plain version in an
# index_add_, so a window sum may differ in its last bits and round the other
# way: 4 bf16 steps of the cell plus 2^-7 of the largest cell (a loose limit;
# PERF.md gives the errors measured against it)
BF16_ACC_RTOL, BF16_ACC_ATOL = 2.0**-5, 2.0**-7
BF16_STEP = 2.0**-7               # one bf16 rounding step, relative (K5 with bf16 features)
REF_TOL = 1e-3                    # GPU vs CPU in f32, scaled by max(1, |want|)
# GPU vs CPU in bf16: cuDNN and the CPU's kernels round bf16 conv outputs
# after different f32 sums; values within the CPU tests' slice tolerance of
# JAX (tests/test_torch_port_bf16.py), gradient norms within the bf16 noise
# of a backward through fifty bf16 layers (the CPU tests see 10-28% per
# tensor between JAX's bf16 and f32 gradients)
REF_TOL_BF16, REF_GRAD_TOL_BF16 = 2e-2, 0.25
# true (h, w) of the serve batch's images inside the bucket
IMAGE_HW = [[832, 1344], [800, 1333], [832, 1110], [600, 1344], [750, 1000], [832, 1344], [512, 768], [700, 1200]]
# the flags the entry points set inside (openset_rcnn_tpu_torch/device.py::entry_numerics)
SERVE_FLAGS = {"cudnn.allow_tf32": False, "matmul.allow_tf32": False,
               "matmul.allow_bf16_reduced_precision_reduction": False}
TRAIN_FLAGS = {**SERVE_FLAGS, "cudnn.deterministic": True, "cudnn.benchmark": False}
EVAL_DATASET = "chip_smoke_eval"
EVAL_LANDSCAPE, EVAL_PORTRAIT = 28, 16  # records of 800x1200 and of 1200x800
EVAL_HW = (800, 1200)
EVAL_TOL = 1e-5                   # fused vs host cascade: boxes and scores, scaled by max(1, max|want|)
ADAPTIVE = -1                     # TPU.ROI_SAMPLING_RATIO of the adaptive grid
# the previous design of K2's adaptive mode (one entry per sample; PERF.md
# §6): its largest distance from the f64 sums on each bwd_cases entry, as
# --timings prints it for a checkout of that design
K2_ADAPTIVE_F64_ERR_BEFORE = {"uniform_b4": 4.395049359118275e-06, "uniform_b16": 4.5264909260822606e-06,
                              "clustered_b4": 2.0521006973694966e-06, "clustered_b16": 3.083213062637924e-06}
# do_train through the CLI: synthetic records on disk (landscape, portrait,
# test), the run's iterations and periods
DO_TRAIN_RECORDS = (32, 16, 8)
DO_TRAIN_ITERS, DO_TRAIN_PERIOD, DO_TRAIN_RESUME_ITERS = 6, 3, 8
# the timed run: --resume from 8 to 20 without evals; its first step is
# warm-up, its last two are profiled, the 9 intervals between them timed
DO_TRAIN_TIMED_ITERS, DO_TRAIN_PROFILED = 20, 2
# multi-process phases: steps, the ddp_nccl records (one global batch of
# landscape images an epoch), and the tolerances against one process
DDP_STEPS, TP_STEPS, DDP_RECORDS = 3, 2, 16
DDP_TIMED = 5                     # ddp_nccl's timed steps on one batch, as train_bf16's
DDP_DATASET = "chip_smoke_ddp"
DDP_METRIC_RTOL = 1e-5            # step-1 metrics but counts (tests/test_torch_port_ddp.py)
DDP_GRAD_TOL = 1e-3               # step-1 gradients, of each tensor's largest reference gradient
# bf16 data parallelism against one process at the global batch: cuDNN rounds
# a bf16 image by its batch, which moved step 1 (PERF.md §6) by 4 of 1993
# foreground RoIs and 4.7e-2 relative at most; the limits are about twice that
DDP_BF16_COUNT_RTOL, DDP_BF16_METRIC_RTOL = 1e-2, 1e-1
DDP_PARAM_TOL = dict(rtol=2e-3, atol=2e-4)  # parameters after the steps (tests/test_engine_mesh.py:50-52)
COUNT_STATS = ("rpn/num_pos_anchors", "rpn/num_neg_anchors", "rpn/obj_num_pos_anchors", "rpn/obj_num_neg_anchors",
               "rpn/num_proposals", "roi_head/num_fg_samples", "roi_head/num_bg_samples")


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def time_ms(torch, fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, flops):
    """(ms, what bounds it): the larger of bytes over HBM rate and flops over f32 rate."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roi_boxes(torch, g, B, R, dev):
    """Boxes over all four levels: edge-clipped, tiny, and aspect > 4 among them."""
    H, W = BUCKET
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    side = torch.exp(math.log(8.0) + u(B, R) * math.log(800.0 / 8.0))
    ar = 0.5 + 1.5 * u(B, R)
    n = R // 8
    ar[:, :n] = 4.5 + 4.0 * u(B, n)
    ar[:, n : 2 * n] = 1.0 / (4.5 + 4.0 * u(B, n))
    w, h = side * ar.sqrt(), side / ar.sqrt()
    cx, cy = u(B, R) * W, u(B, R) * H
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    lim = torch.tensor([W, H, W, H], dtype=torch.float32, device=dev)
    boxes = torch.minimum(boxes.clamp(min=0.0), lim)  # proposals are clipped to the image
    tiny = boxes[:, 2 * n : 3 * n]
    tiny[..., 2:] = tiny[..., :2] + 0.05 + u(B, n, 2)
    return boxes.contiguous()


def clustered_boxes(torch, g, B, R, dev):
    """RoIs jittered around the 20 GT boxes per image of ``bench_batch``, as
    the ROI sampler draws them around the GT: many RoIs over the same cells."""
    gt = bench_batch(torch, B, 20).gt.boxes.to(dev)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    base = torch.gather(gt, 1, (u(B, R) * 20).long()[..., None].expand(B, R, 4))
    side = (base[..., 2:] - base[..., :2]).repeat(1, 1, 2)
    return (base + (u(B, R, 4) - 0.5) * 0.4 * side).contiguous()


def serve_roi_case(torch, dev):
    """K1's inputs at the serving shapes: bf16 P2-P5 of the 832x1344 bucket
    (C=256), the per-level top-1000 over P2-P6 RoIs per image, their levels."""
    from openset_rcnn_tpu_torch.ops.roi_align import assign_levels

    g = torch.Generator(device=dev).manual_seed(1)
    H, W = BUCKET
    R = 4 * 1000 + math.ceil(H / 64) * math.ceil(W / 64)
    feats = [torch.randn(BATCH, math.ceil(H / s), math.ceil(W / s), 256, generator=g, device=dev).to(torch.bfloat16)
             for s in STRIDES]
    boxes = roi_boxes(torch, g, BATCH, R, dev)
    return feats, boxes, assign_levels(boxes)


def phase_roi_align(torch, dev):
    from openset_rcnn_tpu_torch.ops.roi_align import assign_levels, roi_align, roi_align_plain

    feats, boxes, levels = serve_roi_case(torch, dev)
    H, W = BUCKET
    R, C = boxes.shape[1], feats[0].shape[-1]
    got = roi_align(feats, boxes, levels, STRIDES)
    want = roi_align_plain(feats, boxes, levels, STRIDES)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    check(bool((err <= ATOL + RTOL * want.abs()).all()), f"roi_align kernel vs plain: max abs {max_abs}")
    per_level = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    ms = time_ms(torch, lambda: roi_align(feats, boxes, levels, STRIDES), 20)
    plain_ms = time_ms(torch, lambda: roi_align_plain(feats, boxes, levels, STRIDES), 2)
    bytes_moved = got.numel() * 4 + sum(f.numel() * 2 for f in feats) + boxes.numel() * 4 + levels.numel() * 4
    bound_ms, bound_by = bound(bytes_moved, got.numel() * ROI_FLOPS_PER_OUTPUT)
    print(f"roi_align: B={BATCH} R={R} C={C} RoIs per level {per_level}; max abs err {max_abs:.3e}, "
          f"max rel err {max_rel:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}, {bytes_moved / 1e9:.3f} GB)", flush=True)
    del got, want, err
    # the train_bf16 shapes: B=16, R=512, the boxes of phase_roi_align_bwd_bf16
    g = torch.Generator(device=dev).manual_seed(8)
    B, R = TRAIN_BATCH_BF16, TRAIN_ROIS
    feats = [torch.randn(B, math.ceil(H / s), math.ceil(W / s), C, generator=g, device=dev).to(torch.bfloat16)
             for s in STRIDES]
    boxes = roi_boxes(torch, g, B, R, dev)
    levels = assign_levels(boxes)
    got = roi_align(feats, boxes, levels, STRIDES)
    train_err = float((got - roi_align_plain(feats, boxes, levels, STRIDES)).abs().max())
    check(train_err <= ATOL, f"roi_align kernel vs plain at the train shapes: max abs {train_err}")
    train_ms = time_ms(torch, lambda: roi_align(feats, boxes, levels, STRIDES), 20)
    train_bytes = got.numel() * 4 + sum(f.numel() * 2 for f in feats) + boxes.numel() * 4 + levels.numel() * 4
    train_bound, _ = bound(train_bytes, got.numel() * ROI_FLOPS_PER_OUTPUT)
    print(f"roi_align at the train_bf16 shapes: B={B} R={R} C={C}; max abs err {train_err:.3e}; kernel "
          f"{train_ms:.4f} ms, bound {train_bound:.4f} ms ({train_bytes / 1e9:.3f} GB)", flush=True)
    return dict(name="roi_align_fwd", route="cuda", source="openset_rcnn_tpu_torch/csrc/roi_align_fwd.cu",
                replaces="openset_rcnn_tpu/ops/pallas/roi_align_v2.py:269", max_abs_err=max_abs,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                train_shapes=dict(ms=train_ms, bound_ms=train_bound, max_abs_err=train_err))


def nms_case(torch, g, N, dev):
    """Sorted dense boxes, ~20% invalid, with pairs at IoU exactly 0.5."""
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    ctr = u(BATCH, N, 2) * 400.0
    wh = 20.0 + u(BATCH, N, 2) * 180.0
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    x = torch.floor(u(BATCH, 50) * 300.0)
    boxes[:, 0:100:2] = torch.stack([x, x, x + 20, x + 20], -1)
    boxes[:, 1:100:2] = torch.stack([x, x, x + 20, x + 10], -1)
    valid = u(BATCH, N) > 0.2
    return boxes.contiguous(), valid


def class_offset_case(torch, g, N, dev):
    """The known branch's input: candidates of 20 classes, each class's boxes
    shifted apart by the coordinate offset of ``batched_nms_mask``, in
    score order; boxes of different classes never overlap, so few suppress."""
    boxes, valid = nms_case(torch, g, N, dev)
    cls = (torch.rand(BATCH, N, generator=g, device=dev) * 20).floor()
    offset = boxes.amax(dim=(1, 2)) + 1.0
    return (boxes + (cls * offset[:, None])[..., None]).contiguous(), valid


def device_events(torch, fn, reps):
    """[(name, device ms, count)] of the device operations (kernels, memsets,
    copies) of reps calls of fn() under torch.profiler, after one warm-up
    call (launch gaps excluded; an operation the profiler lost is missing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def device_ms(torch, fn, reps, names):
    """{name: mean device ms of one launch} of the kernels whose names
    contain each of ``names``, over reps calls of fn() (``device_events``)."""
    events = device_events(torch, fn, reps)
    out = {}
    for n in names:
        found = [(ms, count) for key, ms, count in events if n in key]
        launches = sum(count for _, count in found)
        out[n] = sum(ms for ms, _ in found) / launches if launches else 0.0
    return out


def phase_nms(torch, dev):
    from openset_rcnn_tpu_torch.ops.nms import nms_keep, nms_keep_plain

    g = torch.Generator(device=dev).manual_seed(2)
    total = dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0, pass1_ms=0.0, pass2_ms=0.0)
    cases = {}
    # the cascade's known (N=2000) and unknown (N=1000) branches on dense
    # boxes, then the known branch's class-offset shape
    for label, N in (("dense", 2000), ("dense", 1000), ("class_offset", 2000)):
        boxes, valid = (nms_case if label == "dense" else class_offset_case)(torch, g, N, dev)
        got = nms_keep(boxes, valid, 0.5)
        want = nms_keep_plain(boxes, valid, 0.5)
        check(torch.equal(got, want), f"nms_keep kernel vs plain, {label} N={N}: "
              f"{int((got != want).sum())} of {got.numel()} differ")
        ms = time_ms(torch, lambda: nms_keep(boxes, valid, 0.5), 20)
        passes = device_ms(torch, lambda: nms_keep(boxes, valid, 0.5), 20, ("nms_iou_mask", "nms_walk"))
        p1_ms, p2_ms = passes["nms_iou_mask"], passes["nms_walk"]
        check(p1_ms > 0 and p2_ms > 0, f"nms_keep: the profiler saw no device time for a pass: {passes}")
        plain_ms = time_ms(torch, lambda: nms_keep_plain(boxes, valid, 0.5), 2)
        # the IoU tests this data needs: each kept box against the valid boxes after it
        later_valid = valid.flip(1).cumsum(1).flip(1) - valid.long()
        tests = int(later_valid[got].sum())
        n_bytes = boxes.numel() * 4 + valid.numel() + got.numel()
        b_ms, b_by = bound(n_bytes, tests * IOU_FLOPS)
        print(f"nms_keep ({label}): B={BATCH} N={N}: kept {int(got.sum())} of {int(valid.sum())} valid, exact; "
              f"kernel {ms:.4f} ms (device time: pass 1 {p1_ms:.4f} ms, pass 2 {p2_ms:.4f} ms), "
              f"plain {plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}); "
              f"{int(got.sum(1).max())} kept boxes in the longest image", flush=True)
        if label == "dense":
            total["ms"] += ms
            total["plain_ms"] += plain_ms
            total["bytes"] += n_bytes
            total["flops"] += tests * IOU_FLOPS
            total["pass1_ms"] += p1_ms
            total["pass2_ms"] += p2_ms
        else:
            cases[label] = dict(N=N, ms=ms, pass1_ms=p1_ms, pass2_ms=p2_ms, plain_ms=plain_ms, bound_ms=b_ms,
                                kept=int(got.sum()), valid=int(valid.sum()))
    bound_ms, bound_by = bound(total["bytes"], total["flops"])
    print(f"nms_keep per serve batch (N=2000 + N=1000, dense): kernel {total['ms']:.4f} ms (device time: pass 1 "
          f"{total['pass1_ms']:.4f} ms, pass 2 {total['pass2_ms']:.4f} ms), bound {bound_ms:.6f} ms", flush=True)
    return dict(name="nms_keep", route="cuda", source="openset_rcnn_tpu_torch/csrc/nms_keep.cu",
                replaces="openset_rcnn_tpu/ops/pallas/nms_kernel.py:61", max_abs_err=0.0,
                ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, pass1_ms=total["pass1_ms"], pass2_ms=total["pass2_ms"], **cases)


def load_cfg(path=CONFIG, **tpu):
    """A config file merged into the defaults, with ``TPU`` keys overridden."""
    from openset_rcnn_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(str(path))
    # A random init regresses zero-size proposals (the IoU loss's saddle);
    # the config's init knob starts them at a positive size.
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0
    for key, value in tpu.items():
        setattr(cfg.TPU, key, value)
    return cfg


# the tracer's counter of each kernel's launches by its wrapper, by kernel name
# (the adaptive grid's modes of K1 and K2 f32 are counted apart)
COUNTED = {"roi_align_fwd": "kernel.roi_align_fwd", "roi_align_fwd_adaptive": "kernel.roi_align_fwd.adaptive",
           "roi_align_bwd": "kernel.roi_align_bwd", "roi_align_bwd_adaptive": "kernel.roi_align_bwd.adaptive",
           "roi_align_bwd_bf16": "kernel.roi_align_bwd_bf16", "iou_match": "kernel.iou_match",
           "nms_keep": "kernel.nms_keep", "roi_align_window": "kernel.roi_align_window",
           "frozen_bn_act": "kernel.frozen_bn"}


def counters():
    """The running tracer's counters."""
    from openset_rcnn_tpu_torch.utils import tracing

    return tracing.snapshot()["counters"]


def reset_launches():
    """Count from 0: tracing on, with a new tracer."""
    from openset_rcnn_tpu_torch.utils import tracing

    tracing.enable()


def read_launches():
    """{kernel: launches} since ``reset_launches``; tracing off again."""
    from openset_rcnn_tpu_torch.utils import tracing

    found = counters()
    tracing.disable()
    return {name: found.get(counter, 0) for name, counter in COUNTED.items()}


PREDICT_KINDS = ("predict.eager", "predict.graph.capture", "predict.graph.replay")
# the kernel the device trace counts for each counted wrapper a serving call
# runs (K4: its second pass, launched once a call)
REPLAYED = {"roi_align_fwd": "roi_align_fwd_kernel", "nms_keep": "nms_walk_kernel",
            "frozen_bn_act": "frozen_bn_act_n"}


@contextlib.contextmanager
def predict_calls():
    """{kind: calls} of ``Predictor.__call__`` in the block, by the tracer's
    counters (filled when it exits; inside ``reset_launches`` ..
    ``read_launches``). A replay calls no kernel wrapper, so the wrappers'
    launch counts cover the eager and the capturing calls only."""
    before = counters()
    calls = {}
    yield calls
    after = counters()
    calls.update({kind: after.get(kind, 0) - before.get(kind, 0) for kind in PREDICT_KINDS})


def wrapper_calls(calls):
    """The calls of ``calls`` (``predict_calls``) that ran the kernel wrappers."""
    return calls["predict.eager"] + calls["predict.graph.capture"]


def replayed_launches(torch, fn, reps, want):
    """{counted name: launches} of reps calls of fn() by the device trace
    (``device_events``): the launches of graph replays, which no wrapper
    counts. 0 for the wrappers a serving call does not run. The profiler
    now and then loses a window's launches: up to three windows, until one
    reads ``want``."""
    out = {name: 0 for name in COUNTED}
    for _ in range(3):
        events = device_events(torch, fn, reps)
        out.update({name: sum(n for key, _, n in events if kernel in key) for name, kernel in REPLAYED.items()})
        mask_passes = sum(n for key, _, n in events if "nms_iou_mask_kernel" in key)
        if out["nms_keep"] == mask_passes and out == want:
            break
    return out


def reference_weights(torch, cfg):
    """The seeded random init with the box head's first FC scaled by 0.02, as
    the CPU tests temper it: random heads on ~100-magnitude features
    otherwise saturate, and turn bf16 steps of the features into large steps
    of the sigmoid IoU head."""
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, build_model

    state = build_model(ModelSpec.from_cfg(cfg), "cpu", seed=0).state_dict()
    state["box_head.fc1.weight"] = state["box_head.fc1.weight"] * 0.02
    return state


def phase_reference(torch, dev, cfg, label, bf16):
    """The serving path on the GPU against the same seeded model on the CPU.
    f32: elementwise. bf16: bf16 near-ties of the centerness put proposals
    in another top-k order on the two devices, so each image's outputs are
    compared as multisets (sorted); every anchor of the 64x96 canvas is a
    proposal at the config's top-k, so the two sets are the same."""
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor

    g = torch.Generator().manual_seed(3)
    mean = torch.tensor(cfg.MODEL.PIXEL_MEAN)
    images = mean + (torch.rand(2, 64, 96, 3, generator=g) * 8.0 - 4.0)  # moderate activations
    image_hw = torch.tensor([[64.0, 96.0], [50.0, 70.0]])
    state = reference_weights(torch, cfg)
    raw_cpu = Predictor(cfg, device="cpu", state_dict=state).raw(images, image_hw)
    raw_gpu = Predictor(cfg, state_dict=state).raw(images.to(dev), image_hw.to(dev))
    tol, errors = REF_TOL_BF16 if bf16 else REF_TOL, {}
    if bf16:
        check(torch.equal(raw_gpu.valid.sum(1).cpu(), raw_cpu.valid.sum(1)), f"reference {label}: valid counts differ")
    else:
        check(torch.equal(raw_gpu.valid.cpu(), raw_cpu.valid), f"reference {label}: valid masks differ")
    for name in ("boxes", "objectness", "pred_iou", "centerness", "min_dist", "known_probs"):
        a, b = getattr(raw_gpu, name).cpu().double(), getattr(raw_cpu, name).double()
        if bf16:
            a = torch.cat([a[i][raw_gpu.valid[i].cpu()].sort(0).values for i in range(a.shape[0])])
            b = torch.cat([b[i][raw_cpu.valid[i]].sort(0).values for i in range(b.shape[0])])
        errors[name] = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
    print(f"reference {label}: GPU vs CPU raw detections (2x64x96"
          f"{', per-image multisets' if bf16 else ''}), scaled errors (limit {tol}) "
          + json.dumps({k: float(f"{e:.3e}") for k, e in errors.items()})
          + f"; {int(raw_cpu.valid.sum())} valid proposals", flush=True)
    for name, err in errors.items():
        check(err <= tol, f"reference {label}: {name} GPU vs CPU scaled error {err:.3e}")


def phase_serve(torch, dev, cfg, label):
    """Predictor at 832x1344, batch 8: the serving path, timed."""
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor
    from openset_rcnn_tpu_torch.ops.nms import nms_keep_plain

    t0 = time.perf_counter()
    predictor = Predictor(cfg, seed=0)
    check(predictor.device.type == "cuda", "Predictor did not choose the GPU")
    images, image_hw = serve_batch(torch, dev)
    for _ in range(SERVE_WARMUP):
        predictor(images, image_hw)
    torch.cuda.synchronize()
    print(f"{label}: model built ({cfg.TPU.DTYPE}) and {SERVE_WARMUP} warm-up batches in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: counts at 0 just before, read just after; every batch
    # replays the graphs captured in the warm-up, calling no kernel wrapper
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    calls = {kind: counters().get(kind, 0) for kind in PREDICT_KINDS}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(SERVE_BATCHES + 1)]
    wall = time.perf_counter()
    events[0].record()
    for i in range(SERVE_BATCHES):
        out = predictor(images, image_hw)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - wall) * 1e3 / SERVE_BATCHES
    calls = {kind: counters().get(kind, 0) - n for kind, n in calls.items()}
    wrappers = read_launches()
    check(calls == {**dict.fromkeys(PREDICT_KINDS, 0), "predict.graph.replay": SERVE_BATCHES},
          f"{label}: the timed batches' calls {calls}, expected {SERVE_BATCHES} replays")
    check(wrappers == {name: 0 for name in wrappers}, f"{label}: a replay launched through a wrapper {wrappers}")
    # the replays' launches, from the device trace of as many replays
    want = {name: 0 for name in COUNTED}
    want.update(roi_align_fwd=SERVE_BATCHES, nms_keep=2 * SERVE_BATCHES,
                frozen_bn_act=trunk_bn_launches(cfg) * SERVE_BATCHES)
    launches = replayed_launches(torch, lambda: predictor(images, image_hw), SERVE_BATCHES, want)
    check(launches == want, f"{label} replays' launches on the device {launches}, expected {want}")
    batch_ms = [events[i].elapsed_time(events[i + 1]) for i in range(SERVE_BATCHES)]
    ms = sum(batch_ms) / SERVE_BATCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # outputs
    D = cfg.MODEL.ROI_HEADS.UNKNOWN_TOPK + cfg.MODEL.ROI_HEADS.KNOWN_TOPK
    check(tuple(out.boxes.shape) == (BATCH, D, 4) and tuple(out.scores.shape) == (BATCH, D), f"{label} shapes")
    check(bool(torch.isfinite(out.boxes).all() and torch.isfinite(out.scores).all()), "non-finite detections")
    check(int(out.valid.sum()) > 0, "no detections")
    raw = predictor.raw(images, image_hw)
    v = raw.valid
    for name in ("boxes", "objectness", "min_dist", "known_probs"):
        check(bool(torch.isfinite(getattr(raw, name)[v]).all()), f"non-finite raw {name}")
    a, b = predictor.cascade(raw), predictor.cascade(raw, keep_fn=nms_keep_plain)
    for name in a._fields:
        check(torch.equal(getattr(a, name), getattr(b, name)), f"cascade {name}: kernel NMS != plain NMS")

    stages = stage_split(torch, lambda mark: predictor(images, image_hw, mark=mark))
    flags = observed_flags(lambda mark: predictor(images, image_hw, mark=mark), SERVE_FLAGS, label)
    profile = profile_step(torch, lambda: predictor(images, image_hw))
    print(f"{label}: {ms:.2f} ms/batch ({BATCH * 1e3 / ms:.2f} img/s) over {SERVE_BATCHES} batches "
          f"(per batch {[round(x, 2) for x in batch_ms]}; host clock {wall:.2f} ms/batch); "
          f"peak memory {peak_gb:.2f} GB; valid detections per image {out.valid.sum(1).tolist()}, "
          f"valid proposals {int(v.sum())}, known overflow {out.known_overflow.tolist()}", flush=True)
    print(f"{label} stages (ms): " + json.dumps({k: round(x, 3) for k, x in stages.items()}), flush=True)
    print(f"{label}: cascade with kernel NMS == cascade with plain NMS; {SERVE_BATCHES} timed batches, each a graph "
          f"replay; the launches of {SERVE_BATCHES} replays by the device trace " + json.dumps(launches), flush=True)
    print(f"{label} profile: " + json.dumps(profile), flush=True)
    print(f"{label}: numerics flags inside a serve batch (the backbone's mark) {json.dumps(flags['inside'])}; "
          f"the caller's, before and after {json.dumps(flags['outside'])}", flush=True)
    return launches, dict(ms_per_batch=ms, img_per_s=BATCH * 1e3 / ms, stages_ms=stages, peak_gb=peak_gb,
                          device_idle_share=profile["idle_share"], flags_inside=flags["inside"])


def serve_batch(torch, dev):
    """The serve paths' batch: 8 images of random uint8 pixels on the card,
    padded to 832x1344, with the true sizes of ``IMAGE_HW``."""
    g = torch.Generator(device=dev).manual_seed(4)
    images = torch.randint(0, 256, (BATCH, *BUCKET, 3), dtype=torch.uint8, generator=g, device=dev)
    return images, torch.tensor(IMAGE_HW[:BATCH], dtype=torch.float32)


def observed_flags(run, want, label):
    """The numerics flags as a mark callback sees them inside ``run(mark)``
    (at the backbone's mark) and as the caller sees them before and after:
    ``want`` inside, the caller's own flags unchanged outside."""
    from openset_rcnn_tpu_torch.device import numerics_flags

    before, seen = numerics_flags(), {}
    run(lambda stage: seen.setdefault(stage, numerics_flags()))
    inside, after = seen["backbone"], numerics_flags()
    check(all(inside[k] == v for k, v in want.items()), f"{label}: flags inside {inside}, expected {want}")
    check(all(flags == inside for flags in seen.values()), f"{label}: flags changed between stages: {seen}")
    check(after == before, f"{label}: the caller's flags {before} came back as {after}")
    return dict(inside=inside, outside=before)


def stage_split(torch, run):
    """Device ms per stage of one more call of ``run(mark)``."""
    marks = [("start", torch.cuda.Event(enable_timing=True))]
    marks[0][1].record()

    def mark(stage):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((stage, e))

    run(mark)
    torch.cuda.synchronize()
    return {s: marks[i][1].elapsed_time(e) for i, (s, e) in enumerate(marks[1:])}


def bench_batch(torch, batch_size, max_gt, images=True):
    """The synthetic 832x1344 training batch of bench.py:105-128, on the host:
    20 GT boxes per image, uniform in position and size, true size 800x1333.
    ``images=False``: the same GT, no pixels."""
    import numpy as np
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    rng = np.random.RandomState(0)
    boxes = np.zeros((batch_size, max_gt, 4), np.float32)
    classes = np.zeros((batch_size, max_gt), np.int32)
    valid = np.zeros((batch_size, max_gt), bool)
    for b in range(batch_size):
        n = 20
        xy = rng.uniform(0, 600, (n, 2))
        wh = rng.uniform(30, 300, (n, 2))
        boxes[b, :n] = np.concatenate([xy, xy + wh], 1)
        classes[b, :n] = rng.randint(0, 20, n)
        valid[b, :n] = True
    shape = (batch_size, *BUCKET, 3) if images else (batch_size, 0, 0, 3)
    images = rng.uniform(0, 255, shape).astype(np.float32)
    return ImageBatch(torch.from_numpy(images), torch.tensor([[800.0, 1333.0]] * batch_size),
                      GroundTruth(torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid)))


def iou_case(torch, dev, B):
    """The anchors of the 832x1344 bucket and bench.py's GT at batch B, made
    tie-laden: every third anchor and image 1's GT on integer coordinates
    (exact IoU ties), a duplicate GT row (ties between GT), a zero-area GT,
    image 3 without valid GT."""
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, compute_anchors

    cfg = load_cfg()
    anchors, _ = compute_anchors(ModelSpec.from_cfg(cfg), BUCKET)
    anchors[::3] = anchors[::3].round()
    gt = bench_batch(torch, B, cfg.TPU.MAX_GT_PER_IMAGE, images=False).gt
    boxes, valid = gt.boxes.clone(), gt.valid.clone()
    boxes[1] = boxes[1].round()
    boxes[1, 5] = boxes[1, 4]
    boxes[2, 1] = torch.tensor([100.0, 100.0, 100.0, 160.0])
    valid[3] = False
    return torch.from_numpy(anchors).to(dev), boxes.to(dev), valid.to(dev)


def iou_timings(torch, anchors, boxes, valid):
    """K3's wrapper time per call (CUDA events around 20 back-to-back calls);
    under the profiler, its device time per call (the sum over its kernels
    of each one's mean per launch: a call launches each once, and a launch
    the profiler lost does not count), its device operations per call, and
    those that are not its kernels (a fill, a memset)."""
    from openset_rcnn_tpu_torch.ops.iou_match import iou_match

    run = lambda: iou_match(anchors, boxes, valid)
    ms = time_ms(torch, run, 20)
    for _ in range(3):  # the profiler now and then loses a window's launches: profile again
        events = device_events(torch, run, 20)
        passes, others = {}, []
        for key, t, count in events:
            name = re.search(r"iou_match\w*", key)
            if name:
                total, n = passes.get(name.group(0), (0.0, 0))
                passes[name.group(0)] = (total + t, n + count)
            else:
                others.append(key[:48])
        if len(passes) == 2:
            break
    passes = {k: t / n for k, (t, n) in passes.items()}
    return dict(ms=ms, device_ms=sum(passes.values()), passes_ms=passes,
                ops_per_call=sum(count for _, _, count in events) / 20, other_ops=others)


def phase_iou_match(torch, dev):
    """K3 at the f32 (B=4) and the bf16 (B=16) train steps' batches."""
    from openset_rcnn_tpu_torch.ops.iou_match import iou_match, iou_match_plain

    figures = {}
    for B in (TRAIN_BATCH, TRAIN_BATCH_BF16):
        anchors, boxes, valid = iou_case(torch, dev, B)
        got = iou_match(anchors, boxes, valid)
        want = iou_match_plain(anchors, boxes, valid)
        torch.cuda.synchronize()
        for name in want._fields:
            a, b = getattr(got, name), getattr(want, name)
            check(torch.equal(a, b), f"iou_match kernel vs plain (B={B}): {name} differs in {int((a != b).sum())} places")
        max_abs = max(float((got.max_iou - want.max_iou).abs().max()),
                      float((got.matched_boxes - want.matched_boxes).abs().max()))
        check(bool((want.max_iou[3] == -1).all()) and not bool(want.rescued[3].any()), "iou_match: image without GT")
        m = want.max_iou[1]
        n_tied = int((m > 0).sum()) - len(torch.unique(m[m > 0]))
        check(n_tied > 0 and int(want.rescued.sum()) > 0, "iou_match: the inputs reach no ties or no rescue")
        t = iou_timings(torch, anchors, boxes, valid)
        check(len(t["passes_ms"]) == 2 and not t["other_ops"] and t["ops_per_call"] <= 2,
              f"iou_match (B={B}): {t['ops_per_call']} device operations per call, kernels {list(t['passes_ms'])}, "
              f"others {t['other_ops']}: its two kernels and nothing else expected")
        plain_ms = time_ms(torch, lambda: iou_match_plain(anchors, boxes, valid), 3)
        G, R = boxes.shape[1], anchors.shape[0]
        # one IoU per anchor and valid GT; anchors and GT read once, four outputs written once
        n_bytes = anchors.numel() * 4 + boxes.numel() * 4 + valid.numel() + B * R * (4 + 4 + 1 + 16)
        n_pairs = int(valid.sum()) * R
        bound_ms, bound_by = bound(n_bytes, n_pairs * IOU_FLOPS)
        print(f"iou_match: B={B} G={G} R={R}, {int(valid.sum())} valid GT, {n_pairs} anchor-GT pairs; "
              f"all four outputs exact ({int(want.rescued.sum())} rescued anchors, {n_tied} tied IoUs in the "
              f"integer image); {t['ops_per_call']:g} device operations per call; wrapper {t['ms']:.4f} ms "
              f"(CUDA events), device {t['device_ms']:.4f} ms per call "
              + json.dumps({k: round(v, 5) for k, v in t["passes_ms"].items()})
              + f"; plain {plain_ms:.2f} ms, bound {bound_ms:.6f} ms ({bound_by})", flush=True)
        figures[B] = dict(max_abs_err=max_abs, ms=t["ms"], device_ms=t["device_ms"], passes_ms=t["passes_ms"],
                          ops_per_call=t["ops_per_call"], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del got, want
    return dict(name="iou_match", route="cuda", source="openset_rcnn_tpu_torch/csrc/iou_match.cu",
                replaces="openset_rcnn_tpu/ops/pallas/iou_match_kernel.py:100", library_ms=None,
                **figures[TRAIN_BATCH], b16=figures[TRAIN_BATCH_BF16])


def phase_launch_floor(torch, dev):
    """An empty kernel (csrc/launch_floor.cu): its time per launch back to
    back through ctypes (CUDA events) and on the device (profiler), at one
    block and at a grid of 4 blocks per SM x 256 threads (K3's at B=16)."""
    from openset_rcnn_tpu_torch import _native

    lib = _native.load("launch_floor")
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for label, blocks, threads in (("1x32", 1, 32), (f"{4 * sms}x256", 4 * sms, 256)):
        run = lambda: _native.check(lib, "empty_launch", lib.empty_launch(blocks, threads, stream))
        ms = time_ms(torch, run, 200)
        dev_ms = device_ms(torch, run, 200, ("empty_kernel",))["empty_kernel"]
        check(dev_ms > 0, "launch floor: the profiler saw no empty kernel")
        out[label] = dict(ms=ms, device_ms=dev_ms)
        print(f"launch floor: empty kernel, {blocks} x {threads} threads: {ms:.4f} ms per launch back to back "
              f"(CUDA events around 200 calls), device {dev_ms:.4f} ms", flush=True)
    return out


def bwd_cases(torch, dev):
    """K2 f32's inputs: (label, B, boxes, levels, cotangent) at the f32 train
    shapes (B=4), at the train_bf16 batch (B=16), uniform and clustered
    around the GT (many RoIs over one cell)."""
    from openset_rcnn_tpu_torch.ops.roi_align import assign_levels

    g = torch.Generator(device=dev).manual_seed(5)
    R, C, P = TRAIN_ROIS, 256, 7
    for label, B, make_boxes in (("uniform", TRAIN_BATCH, roi_boxes), ("uniform", TRAIN_BATCH_BF16, roi_boxes),
                                 ("clustered", TRAIN_BATCH, clustered_boxes),
                                 ("clustered", TRAIN_BATCH_BF16, clustered_boxes)):
        boxes = make_boxes(torch, g, B, R, dev)
        yield label, B, boxes, assign_levels(boxes), torch.randn(B, R, P, P, C, generator=g, device=dev)


def phase_roi_align_bwd(torch, dev):
    """K2 f32 on ``bwd_cases``: within tolerance of its plain version and
    bitwise equal from launch to launch."""
    from openset_rcnn_tpu_torch.ops.roi_align import roi_align_bwd, roi_align_bwd_plain

    P, S = 7, 2
    H, W = BUCKET
    level_hw = [(math.ceil(H / s), math.ceil(W / s)) for s in STRIDES]
    figures = {}
    for label, B, boxes, levels, cot in bwd_cases(torch, dev):
        R, C = cot.shape[1], cot.shape[-1]
        got = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, S)
        again = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, S)
        want = roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, S)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"roi_align_bwd ({label}, B={B}): two launches differ")
        scale = max(1.0, max(float(w.abs().max()) for w in want))
        max_abs = max(float((a - w).abs().max()) for a, w in zip(got, want))
        check(max_abs <= BWD_TOL * scale,
              f"roi_align_bwd kernel vs plain ({label}, B={B}): max abs {max_abs} > {BWD_TOL} * {scale}")
        # both against the same sums in f64: which order strays further
        exact = roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, S, acc_dtype=torch.float64)
        kernel_exact = max(float((a.double() - e).abs().max()) for a, e in zip(got, exact))
        plain_exact = max(float((w.double() - e).abs().max()) for w, e in zip(want, exact))
        del got, again, exact
        ms = time_ms(torch, lambda: roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, S), 20)
        plain_ms = time_ms(torch, lambda: roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, S), 2)
        # the cotangent, boxes and levels read once; the f32 accumulators written once
        acc_bytes = sum(w.numel() * 4 for w in want)
        n_bytes = cot.numel() * 4 + boxes.numel() * 4 + levels.numel() * 4 + acc_bytes
        bound_ms, bound_by = bound(n_bytes, cot.numel() * (S * S * ROI_BWD_FLOPS_PER_SAMPLE + 1))
        per_level = torch.bincount(levels.flatten().long(), minlength=4).tolist()
        print(f"roi_align_bwd ({label}): B={B} R={R} C={C} RoIs per level {per_level}; max abs err {max_abs:.3e} "
              f"(limit {BWD_TOL * scale:.3e}; against the f64 sums: kernel {kernel_exact:.3e}, plain "
              f"{plain_exact:.3e}); two launches bitwise equal; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e9:.3f} GB of which "
              f"{acc_bytes / 1e9:.3f} GB accumulators)", flush=True)
        figures[f"{label}_b{B}"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=bound_by, kernel_err_f64=kernel_exact, plain_err_f64=plain_exact)
        del want, cot
    main = figures[f"uniform_b{TRAIN_BATCH}"]
    return dict(name="roi_align_bwd", route="cuda", source="openset_rcnn_tpu_torch/csrc/roi_align_bwd.cu",
                replaces="openset_rcnn_tpu/ops/pallas/roi_align_v2.py:487", library_ms=None, **main,
                **{k: v for k, v in figures.items() if k != f"uniform_b{TRAIN_BATCH}"})


def adaptive_samples(torch, boxes, levels, P=7):
    """(B, R) samples a bin of the adaptive grid, n_y * n_x, as the kernels
    count them (clip(ceil(extent / P), 1, 8) per axis at the RoI's level)."""
    scale = 1.0 / torch.tensor(STRIDES, dtype=torch.float32, device=boxes.device)[levels.long()]
    ext = torch.stack([(boxes[..., 3] * scale - 0.5) - (boxes[..., 1] * scale - 0.5),
                       (boxes[..., 2] * scale - 0.5) - (boxes[..., 0] * scale - 0.5)], -1)
    n = torch.clamp(torch.ceil(ext / torch.full_like(ext, P)), 1, 8)
    return n[..., 0] * n[..., 1], n


def phase_roi_align_adaptive(torch, dev):
    """K1 on the adaptive grid (sampling_ratio -1) against its plain version
    at the serving shapes and at B=16, R=512, on boxes of sides 8-800 px
    (tiny: 1 sample a bin; elongated: the clip at 8), timed beside the
    static grid's K1 on the same boxes."""
    from openset_rcnn_tpu_torch.ops.roi_align import adaptive_table_widths, assign_levels, roi_align, roi_align_plain

    H, W = BUCKET
    C = 256
    level_hw = [(math.ceil(H / s), math.ceil(W / s)) for s in STRIDES]
    figures = {}
    for label, B, R, seed in (("serve", BATCH, 4 * 1000 + math.ceil(H / 64) * math.ceil(W / 64), 11),
                              ("train_bf16", TRAIN_BATCH_BF16, TRAIN_ROIS, 12)):
        g = torch.Generator(device=dev).manual_seed(seed)
        feats = [torch.randn(B, math.ceil(H / s), math.ceil(W / s), C, generator=g, device=dev).to(torch.bfloat16)
                 for s in STRIDES]
        boxes = roi_boxes(torch, g, B, R, dev)
        levels = assign_levels(boxes)
        samples, n = adaptive_samples(torch, boxes, levels)
        check(float(n.min()) == 1.0 and float(n.max()) == 8.0,
              f"roi_align adaptive ({label}): samples per bin axis span {float(n.min())}-{float(n.max())}, not 1-8")
        widest, most_bins = adaptive_table_widths(boxes, levels, level_hw, STRIDES)
        got = roi_align(feats, boxes, levels, STRIDES, 7, ADAPTIVE)
        want = roi_align_plain(feats, boxes, levels, STRIDES, 7, ADAPTIVE)
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_abs = float(err.max())
        bitwise = bool(torch.equal(got, want))
        check(bool((err <= ATOL + RTOL * want.abs()).all()), f"roi_align adaptive ({label}) kernel vs plain: "
              f"max abs {max_abs}")
        del want, err
        ms = time_ms(torch, lambda: roi_align(feats, boxes, levels, STRIDES, 7, ADAPTIVE), 10)
        static_ms = time_ms(torch, lambda: roi_align(feats, boxes, levels, STRIDES), 10)
        plain_ms = time_ms(torch, lambda: roi_align_plain(feats, boxes, levels, STRIDES, 7, ADAPTIVE), 1)
        bytes_moved = got.numel() * 4 + sum(f.numel() * 2 for f in feats) + boxes.numel() * 4 + levels.numel() * 4
        # per output value: 8 flops a sample this run's boxes take, then the division
        flops = C * 49 * float((samples * 8 + 1).sum())
        bound_ms, bound_by = bound(bytes_moved, flops)
        hist = torch.bincount(n.flatten().long(), minlength=9)[1:].tolist()
        print(f"roi_align adaptive ({label}): B={B} R={R} C={C}; samples per bin axis 1..8: {hist}, mean samples a "
              f"bin {float(samples.mean()):.2f} (static grid: 4); the plain table model's widest axis table {widest} "
              f"pairs (bound 16), at most {most_bins} bins a row or column (bound 7); kernel vs plain "
              f"{'bitwise equal' if bitwise else ''} max abs err {max_abs:.3e}; kernel {ms:.4f} ms, static-grid K1 on "
              f"the same boxes {static_ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{bytes_moved / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP)", flush=True)
        figures[label] = dict(max_abs_err=max_abs, bitwise=bitwise, ms=ms, static_ms=static_ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, mean_samples=float(samples.mean()))
        del got, feats
    return dict(name="roi_align_fwd_adaptive", route="cuda", source="openset_rcnn_tpu_torch/csrc/roi_align_fwd.cu",
                replaces="openset_rcnn_tpu/ops/pallas/roi_align_v2.py:269", library_ms=None,
                jax_adaptive_path="openset_rcnn_tpu/ops/roi_align.py:75", **figures["serve"],
                train_shapes=figures["train_bf16"])


def phase_roi_align_bwd_adaptive(torch, dev):
    """K2 f32 on the adaptive grid on ``bwd_cases``: within tolerance of its
    plain version and bitwise equal from launch to launch; its distance from
    the f64 sums beside the previous design's."""
    from openset_rcnn_tpu_torch.ops.roi_align import adaptive_table_widths, roi_align_bwd, roi_align_bwd_plain

    P = 7
    H, W = BUCKET
    level_hw = [(math.ceil(H / s), math.ceil(W / s)) for s in STRIDES]
    figures = {}
    for label, B, boxes, levels, cot in bwd_cases(torch, dev):
        R, C = cot.shape[1], cot.shape[-1]
        samples, _ = adaptive_samples(torch, boxes, levels)
        got = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, ADAPTIVE)
        again = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, ADAPTIVE)
        want = roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, ADAPTIVE)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"roi_align_bwd adaptive ({label}, B={B}): two launches differ")
        scale = max(1.0, max(float(w.abs().max()) for w in want))
        max_abs = max(float((a - w).abs().max()) for a, w in zip(got, want))
        check(max_abs <= BWD_TOL * scale,
              f"roi_align_bwd adaptive kernel vs plain ({label}, B={B}): max abs {max_abs} > {BWD_TOL} * {scale}")
        exact = roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, ADAPTIVE, acc_dtype=torch.float64)
        kernel_exact = max(float((a.double() - e).abs().max()) for a, e in zip(got, exact))
        plain_exact = max(float((w.double() - e).abs().max()) for w, e in zip(want, exact))
        widest, most_bins = adaptive_table_widths(boxes, levels, level_hw, STRIDES)
        del got, again, exact
        ms = time_ms(torch, lambda: roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, ADAPTIVE), 10)
        static_ms = time_ms(torch, lambda: roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, 2), 10)
        plain_ms = time_ms(torch, lambda: roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, ADAPTIVE), 1)
        acc_bytes = sum(w.numel() * 4 for w in want)
        n_bytes = cot.numel() * 4 + boxes.numel() * 4 + levels.numel() * 4 + acc_bytes
        flops = C * P * P * float((samples * ROI_BWD_FLOPS_PER_SAMPLE + 1).sum())
        bound_ms, bound_by = bound(n_bytes, flops)
        before = K2_ADAPTIVE_F64_ERR_BEFORE[f"{label}_b{B}"]
        print(f"roi_align_bwd adaptive ({label}): B={B} R={R} C={C}, mean samples a bin "
              f"{float(samples.mean()):.2f}; the plain table model's widest axis table {widest} pairs, at most "
              f"{most_bins} bins a row or column; max abs err {max_abs:.3e} (limit {BWD_TOL * scale:.3e}; "
              f"against the f64 sums: kernel {kernel_exact:.3e}, the previous design {before:.3e} (PERF.md's "
              f"figure, not this run's), plain {plain_exact:.3e}); two launches bitwise equal; kernel {ms:.4f} ms, "
              f"static-grid K2 f32 on the same RoIs {static_ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e9:.3f} GB)", flush=True)
        figures[f"{label}_b{B}"] = dict(max_abs_err=max_abs, ms=ms, static_ms=static_ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=bound_by, mean_samples=float(samples.mean()),
                                        kernel_err_f64=kernel_exact, plain_err_f64=plain_exact)
        del want, cot
    main = figures[f"uniform_b{TRAIN_BATCH}"]
    return dict(name="roi_align_bwd_adaptive", route="cuda", source="openset_rcnn_tpu_torch/csrc/roi_align_bwd.cu",
                replaces="openset_rcnn_tpu/ops/pallas/roi_align_v2.py:487", library_ms=None,
                jax_adaptive_path="openset_rcnn_tpu/ops/roi_align.py:425", **main,
                **{k: v for k, v in figures.items() if k != f"uniform_b{TRAIN_BATCH}"})


def timings(torch, dev):
    """K1, K4, K3 and K2 f32 only, no gates (``--timings``): the wrapper's
    time (CUDA events) and the device time per call (profiler). K1 and K4 at
    the serving shapes of phases 3 and 4 (K4 per serve batch: N=2000 then
    N=1000), each timed before and after a torch.profiler session, as
    phase 4 times its second case; K1's adaptive mode at phase 6a's serving
    shapes; K2 f32, static and adaptive, on ``bwd_cases``, the adaptive
    mode also with its distance from the f64 sums."""
    from openset_rcnn_tpu_torch.ops.nms import nms_keep
    from openset_rcnn_tpu_torch.ops.roi_align import assign_levels, roi_align, roi_align_bwd, roi_align_bwd_plain

    out = {}
    feats, boxes, levels = serve_roi_case(torch, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    cases = [nms_case(torch, g, N, dev) for N in (2000, 1000)]
    for name, run in (("roi_align_fwd", lambda: roi_align(feats, boxes, levels, STRIDES)),
                      ("nms_keep_per_batch", lambda: [nms_keep(b, v, 0.5) for b, v in cases])):
        ms = time_ms(torch, run, 20)
        events = device_events(torch, run, 20)
        out[name] = dict(ms=ms, device_ms=sum(t for _, t, _ in events) / 20, ms_after_profiler=time_ms(torch, run, 20))
    del feats, boxes, levels
    H, W = BUCKET
    # K1's adaptive mode on phase 6a's serving case
    g = torch.Generator(device=dev).manual_seed(11)
    feats = [torch.randn(BATCH, math.ceil(H / s), math.ceil(W / s), 256, generator=g, device=dev).to(torch.bfloat16)
             for s in STRIDES]
    boxes = roi_boxes(torch, g, BATCH, 4 * 1000 + math.ceil(H / 64) * math.ceil(W / 64), dev)
    levels = assign_levels(boxes)
    run = lambda: roi_align(feats, boxes, levels, STRIDES, 7, ADAPTIVE)
    events = device_events(torch, run, 20)
    out["roi_align_fwd_adaptive"] = dict(ms=time_ms(torch, run, 20), device_ms=sum(t for _, t, _ in events) / 20)
    del feats, boxes, levels
    for B in (TRAIN_BATCH, TRAIN_BATCH_BF16):
        out[f"iou_match_b{B}"] = iou_timings(torch, *iou_case(torch, dev, B))
    level_hw = [(math.ceil(H / s), math.ceil(W / s)) for s in STRIDES]
    for label, B, boxes, levels, cot in bwd_cases(torch, dev):
        for name, ratio, kernel in (("roi_align_bwd", 2, "roi_align_bwd_kernel"),
                                    ("roi_align_bwd_adaptive", ADAPTIVE, "roi_align_bwd_adaptive_kernel")):
            run = lambda: roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, 7, ratio)
            events = device_events(torch, run, 20)
            out[f"{name}_{label}_b{B}"] = dict(
                ms=time_ms(torch, run, 20), device_ms=sum(t for _, t, _ in events) / 20,
                kernel_device_ms=device_ms(torch, run, 20, (kernel,))[kernel],
                ops_per_call=sum(count for _, _, count in events) / 20)
        exact = roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, 7, ADAPTIVE, acc_dtype=torch.float64)
        out[f"roi_align_bwd_adaptive_{label}_b{B}"]["kernel_err_f64"] = max(
            float((a.double() - e).abs().max())
            for a, e in zip(roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, 7, ADAPTIVE), exact))
        del cot, exact
    return out


def group_grad_norms(model):
    """{top-level module: L2 norm of its parameters' gradients}."""
    sq = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            top = name.split(".")[0]
            sq[top] = sq.get(top, 0.0) + float(p.grad.double().pow(2).sum())
    return {k: math.sqrt(v) for k, v in sq.items()}


def phase_train_reference(torch, dev, cfg, label, bf16, wide=False):
    """One training step on the GPU against the same seeded model on the CPU.
    ``wide``: a 64x256 canvas whose first GT box of each image is 230 x 30,
    which the window-fit rule pools one level up (the GT boxes join the
    sampled RoIs as foreground)."""
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.ops.roi_align import assign_levels, assign_levels_window_fit
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    B, H, W, G = 2, 64, 256 if wide else 96, 8
    g = torch.Generator().manual_seed(6)
    u = lambda *s: torch.rand(*s, generator=g)
    images = torch.tensor(cfg.MODEL.PIXEL_MEAN) + (u(B, H, W, 3) * 8.0 - 4.0)  # moderate activations
    xy, wh = u(B, G, 2) * 60.0, 10.0 + u(B, G, 2) * 30.0
    boxes = torch.cat([xy, xy + wh], -1)
    if wide:
        boxes[:, 0] = torch.tensor([10.0, 12.0, 240.0, 42.0])
        bumped = int((assign_levels_window_fit(boxes[:, :1], STRIDES) > assign_levels(boxes[:, :1])).sum())
        check(bumped == B, "train reference: the elongated GT boxes are not moved up a level")
    classes = torch.randint(0, 81, (B, G), generator=g, dtype=torch.int32)
    classes[:, :3] = torch.tensor([[2, 5, 40], [11, 19, 70]], dtype=torch.int32)  # known, known, unknown
    valid = u(B, G) > 0.3
    valid[:, :3] = True
    batch = ImageBatch(images, torch.tensor([[64.0, float(W)], [50.0, W - 26.0]]),
                       GroundTruth(boxes, classes, valid))
    state = reference_weights(torch, cfg)
    cpu, gpu = Trainer(cfg, device="cpu", state_dict=state), Trainer(cfg, state_dict=state)
    anchors, level_sizes = cpu.anchors((H, W))
    n_props = sum(min(cpu.spec.pre_nms_topk_train, n) for n in level_sizes)
    draws = {"rpn": u(B, 2, 2, anchors.shape[0]), "roi": u(B, 3, n_props + G)}
    rates = cpu.model.branch_rates
    if any(r > 0 for r in rates):  # the backbone's drop-path masks: the two devices' generators differ
        draws["drop_path"] = u(len(rates), B) < torch.tensor([1.0 - r for r in rates])[:, None]
    want = cpu.step(batch, uniforms=draws)
    got = gpu.step(batch, uniforms={k: v.to(dev) for k, v in draws.items()})
    check(set(got) == set(want), f"train reference {label}: metric keys differ")
    tol, grad_tol = (REF_TOL_BF16, REF_GRAD_TOL_BF16) if bf16 else (REF_TOL, REF_TOL)
    counts = {k: (float(got[k]), float(want[k])) for k in COUNT_STATS}
    errors = {k: abs(float(got[k]) - float(w)) / max(1.0, abs(float(w))) for k, w in want.items() if k not in counts}
    norms_cpu, norms_gpu = group_grad_norms(cpu.model), group_grad_norms(gpu.model)
    check(set(norms_cpu) == set(norms_gpu), f"train reference {label}: modules with gradients differ")
    grad_errors = {k: abs(norms_gpu[k] - b) / max(1.0, b) for k, b in norms_cpu.items()}
    print(f"train reference {label}: GPU vs CPU step (2x{H}x{W}): scaled errors of {len(errors)} metrics (limit {tol}) "
          + json.dumps({k: float(f"{e:.3e}") for k, e in errors.items()})
          + f"; of {len(grad_errors)} gradient norms (limit {grad_tol}) "
          + json.dumps({k: float(f"{e:.3e}") for k, e in grad_errors.items()})
          + "; counts (GPU, CPU) " + json.dumps(counts), flush=True)
    for k, (a, b) in counts.items():
        check(a == b, f"train reference {label}: {k} GPU {a} vs CPU {b}")
    for k, err in errors.items():
        check(math.isfinite(float(got[k])) and err <= tol, f"train reference {label}: {k} scaled error {err:.3e}")
    for k, err in grad_errors.items():
        check(err <= grad_tol, f"train reference {label}: {k} gradient norm scaled error {err:.3e}")


def calibrate_frozen_bn(torch, model, images, image_hw):
    """Set every FrozenBN's mean and variance to those of its input on
    ``images``, layer after layer (scale 1, bias 0 kept), as a pretrained
    trunk's statistics keep its activations near unit scale. With identity
    statistics a random trunk's activations grow by orders of magnitude
    through its fifty layers, and at the production config's learning rate
    (0.02, warm-up over 100 steps) the losses leave the finite range within
    the phase's seven steps. A FrozenBN's input is the output of the
    convolution before it, read there: the trunk hands the buffers to its
    FrozenBN operator and calls no FrozenBN module."""
    from openset_rcnn_tpu_torch.models.resnet import FrozenBN

    def hook_for(bn):
        def hook(conv, args, out):
            x = out.float()
            bn.mean.copy_(x.mean(dim=(0, 2, 3)))
            bn.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))
        return hook

    pairs = (("stem_conv", "stem_bn"), ("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"),
             ("shortcut", "shortcut_bn"))
    handles = [getattr(m, conv).register_forward_hook(hook_for(getattr(m, bn))) for m in model.modules()
               for conv, bn in pairs if isinstance(getattr(m, bn, None), FrozenBN)]
    check(len(handles) == sum(isinstance(m, FrozenBN) for m in model.modules()),
          "calibrate_frozen_bn: a FrozenBN without its convolution")
    with torch.no_grad():
        model.features(images, image_hw)
    for h in handles:
        h.remove()
    return len(handles)


def phase_train(torch, dev, cfg, label, batch_size, calibrate=False):
    """Trainer at 832x1344 on the synthetic batch of bench.py: the training
    path, timed. ``calibrate``: FrozenBN statistics from the batch (see
    ``calibrate_frozen_bn``)."""
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    check(cfg.SOLVER.IMS_PER_BATCH == batch_size, f"the config trains at batch {cfg.SOLVER.IMS_PER_BATCH}")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, seed=0)
    check(trainer.device.type == "cuda", "Trainer did not choose the GPU")
    host = bench_batch(torch, batch_size, cfg.TPU.MAX_GT_PER_IMAGE)
    batch = ImageBatch(host.images.to(dev), host.image_hw.to(dev),
                       GroundTruth(host.gt.boxes.to(dev), host.gt.classes.to(dev), host.gt.valid.to(dev)))
    model = trainer.model
    calibrated = calibrate_frozen_bn(torch, model, batch.images, batch.image_hw) if calibrate else 0
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    for _ in range(TRAIN_WARMUP):
        trainer.step(batch)
    torch.cuda.synchronize()
    clip = cfg.SOLVER.CLIP_GRADIENTS
    print(f"{label}: model built ({cfg.MODEL.BACKBONE.NAME}, {cfg.TPU.DTYPE}, RoIAlign backward "
          f"{cfg.TPU.ROI_ALIGN_BWD}, drop-path up to {max(model.branch_rates, default=0.0)}, gradient clipping "
          f"{f'{clip.CLIP_TYPE} {clip.CLIP_VALUE}' if clip.ENABLED else 'off'}"
          f"{f', {calibrated} FrozenBN statistics calibrated on the batch' if calibrate else ''}) and "
          f"{TRAIN_WARMUP} warm-up steps in {time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: counts at 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    history = []
    wall = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        history.append(trainer.step(batch))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - wall) * 1e3 / TRAIN_STEPS
    launches = read_launches()
    fwd, bwd = train_kernels(cfg)
    want = {name: 0 for name in launches}
    want.update({fwd: TRAIN_STEPS, bwd: TRAIN_STEPS, "iou_match": 2 * TRAIN_STEPS,
                 "frozen_bn_act": train_bn_launches(cfg) * TRAIN_STEPS})
    check(launches == want, f"{label} launches {launches}, expected {want}")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(TRAIN_STEPS)]
    ms = sum(step_ms) / TRAIN_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in history:
        for k, v in m.items():
            check(math.isfinite(float(v)), f"{label}: {k} is not finite")

    stages = stage_split(torch, lambda mark: trainer.step(batch, mark=mark))
    stages["forward"] = sum(x for s, x in stages.items() if s not in ("backward", "optimizer"))
    flags = observed_flags(lambda mark: trainer.step(batch, mark=mark), TRAIN_FLAGS, label)
    last = history[-1]
    profile = profile_step(torch, lambda: trainer.step(batch))

    for n, p in model.named_parameters():
        if n in frozen:
            check(torch.equal(p, frozen[n]), f"{label}: frozen parameter {n} changed")
        else:
            check(p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32,
                  f"{label}: parameter {n} or its gradient is not f32")
    for n, b in model.named_buffers():
        check(torch.equal(b, buffers[n]), f"{label}: buffer {n} changed")
    unmoved, below_ulp = unmoved_params(torch, trainer, before)
    check(not unmoved, f"{label}: trainable parameters that did not move: {unmoved}")
    n_params, differ, worst = repeat_step(torch, trainer, batch)
    by_module = {}
    for n in differ:
        by_module[n.split(".")[0]] = by_module.get(n.split(".")[0], 0) + 1
    print(f"{label}: two steps from one state on one batch: " + (
        f"all {n_params} parameter tensors bitwise equal" if not differ else
        f"{len(differ)} of {n_params} parameter tensors differ (largest difference {worst:.3e}; by module "
        f"{json.dumps(by_module)}; first {differ[:3]})"), flush=True)
    check(not differ, f"{label}: two steps from one state on one batch differ in {len(differ)} parameter tensors")
    print(f"{label}: numerics flags inside a train step (the backbone's mark) {json.dumps(flags['inside'])}; "
          f"the caller's, before and after {json.dumps(flags['outside'])}", flush=True)
    print(f"{label}: {ms:.2f} ms/step ({batch_size * 1e3 / ms:.2f} img/s) at batch {batch_size} over {TRAIN_STEPS} "
          f"steps (per step {[round(x, 2) for x in step_ms]}; host clock {wall:.2f} ms/step); peak memory "
          f"{peak_gb:.2f} GB; {len(frozen)} frozen parameters and {len(buffers)} buffers unchanged, "
          f"{len(before) - len(below_ulp)} trainable parameters moved, {len(below_ulp)} whose last update lies "
          f"below half an f32 step of every element{f' (e.g. {below_ulp[:3]})' if below_ulp else ''}", flush=True)
    print(f"{label} stages (ms): " + json.dumps({k: round(x, 3) for k, x in stages.items()}), flush=True)
    print(f"{label}: last timed step " + json.dumps({k: round(float(v), 6) for k, v in last.items()}), flush=True)
    print(f"{label}: launches over the timed steps " + json.dumps(launches), flush=True)
    print(f"{label} profile: " + json.dumps(profile), flush=True)
    return launches, dict(ms_per_step=ms, img_per_s=batch_size * 1e3 / ms, batch=batch_size, stages_ms=stages,
                          peak_gb=peak_gb, device_idle_share=profile["idle_share"],
                          repeat_bitwise=not differ, flags_inside=flags["inside"])


def unmoved_params(torch, trainer, before):
    """(trainable tensors equal to ``before`` though the last step's update,
    lr x momentum buffer, reaches half an f32 step of one of their elements;
    those equal to ``before`` whose last update lies below half a step of
    every element, which no f32 update can move: a LayerNorm scale near 1
    under a small learning rate, a clipped gradient)."""
    opt = trainer.state.optimizer
    lr = opt.param_groups[0]["lr"]
    unmoved, below_ulp = [], []
    for n, p in trainer.model.named_parameters():
        if n in before and torch.equal(p, before[n]):
            update = lr * opt.state[p]["momentum_buffer"].abs()
            a = p.detach().abs()
            movable = bool((update > (torch.nextafter(a, torch.full_like(a, math.inf)) - a) / 2).any())
            (unmoved if movable else below_ulp).append(n)
    return unmoved, below_ulp


def phase_train_remat(torch, dev, cfg, train):
    """``TPU.REMAT true`` on ``cfg`` at batch 4 on bench.py's batch: one step
    from the seeded init against the same step without remat, bitwise (a
    gate); then timed steps, launches and peak memory, beside ``train``'s."""
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    host = bench_batch(torch, TRAIN_BATCH, cfg.TPU.MAX_GT_PER_IMAGE)
    batch = ImageBatch(host.images.to(dev), host.image_hw.to(dev),
                       GroundTruth(host.gt.boxes.to(dev), host.gt.classes.to(dev), host.gt.valid.to(dev)))
    check(not cfg.TPU.REMAT, "train_remat: the reference step must run without remat")
    plain = Trainer(cfg, seed=0)
    plain.step(batch)
    want = {n: p.detach().clone() for n, p in plain.model.named_parameters()}
    del plain
    torch.cuda.empty_cache()
    cfg = cfg.clone()
    cfg.TPU.REMAT = True
    trainer = Trainer(cfg, seed=0)
    check(trainer.model.backbone.remat, "train_remat: the backbone does not recompute its blocks")
    trainer.step(batch)
    torch.cuda.synchronize()
    differ = [n for n, p in trainer.model.named_parameters() if not torch.equal(p, want[n])]
    worst = max((float((p - want[n]).abs().max()) for n, p in trainer.model.named_parameters() if n in differ),
                default=0.0)
    print(f"train_remat: one step with TPU.REMAT true against one without, from the same seeded state: "
          + (f"all {len(want)} parameter tensors bitwise equal" if not differ else
             f"{len(differ)} of {len(want)} differ (largest {worst:.3e}; first {differ[:3]})"), flush=True)
    check(not differ, f"train_remat: {len(differ)} parameter tensors differ from the step without remat")
    for _ in range(TRAIN_WARMUP - 1):
        trainer.step(batch)
    torch.cuda.synchronize()

    # the main path: counts at 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    history = []
    events[0].record()
    for i in range(TRAIN_STEPS):
        history.append(trainer.step(batch))
        events[i + 1].record()
    torch.cuda.synchronize()
    launches = read_launches()
    fwd, bwd = train_kernels(cfg)
    expected = {name: 0 for name in launches}
    expected.update({fwd: TRAIN_STEPS, bwd: TRAIN_STEPS, "iou_match": 2 * TRAIN_STEPS,
                     "frozen_bn_act": train_bn_launches(cfg) * TRAIN_STEPS})
    check(launches == expected, f"train_remat launches {launches}, expected {expected}")
    for m in history:
        for k, v in m.items():
            check(math.isfinite(float(v)), f"train_remat: {k} is not finite")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(TRAIN_STEPS)]
    ms = sum(step_ms) / TRAIN_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"train_remat: {ms:.2f} ms/step ({TRAIN_BATCH * 1e3 / ms:.2f} img/s) at batch {TRAIN_BATCH} over "
          f"{TRAIN_STEPS} steps (per step {[round(x, 2) for x in step_ms]}); peak memory {peak_gb:.2f} GB; "
          f"without remat (train): {train['ms_per_step']:.2f} ms/step, peak {train['peak_gb']:.2f} GB; "
          f"launches " + json.dumps(launches), flush=True)
    return launches, dict(ms_per_step=ms, img_per_s=TRAIN_BATCH * 1e3 / ms, batch=TRAIN_BATCH, peak_gb=peak_gb,
                          first_step_bitwise_without_remat=True, train_ms_per_step=train["ms_per_step"],
                          train_peak_gb=train["peak_gb"])


def train_kernels(cfg):
    """The RoIAlign forward and backward kernels a train step of ``cfg``
    launches: the adaptive grid's modes (which take f32 accumulators), or
    the static grid's K1 and the K2 mode of ``TPU.ROI_ALIGN_BWD``."""
    if cfg.TPU.ROI_SAMPLING_RATIO == ADAPTIVE:
        return "roi_align_fwd_adaptive", "roi_align_bwd_adaptive"
    return "roi_align_fwd", "roi_align_bwd_bf16" if cfg.TPU.ROI_ALIGN_BWD == "pallas_bf16" else "roi_align_bwd"


def trunk_bn_launches(cfg):
    """The FrozenBN kernel's launches in one trunk forward of ``cfg``: the
    stem's and three a bottleneck block on a ResNet (49 on R50), none on
    the transformer trunks."""
    from openset_rcnn_tpu_torch.models.detector import RESNET
    from openset_rcnn_tpu_torch.models.resnet import STAGE_BLOCKS

    if cfg.MODEL.BACKBONE.NAME != RESNET:
        return 0
    return 1 + 3 * sum(STAGE_BLOCKS[cfg.MODEL.RESNETS.DEPTH])


def train_bn_launches(cfg):
    """Those of one train step: the forward's; with ``TPU.REMAT`` also the
    recomputed forward of every block above ``FREEZE_AT`` (the frozen
    stages' blocks take and hold nothing that needs a gradient, so nothing
    of theirs is recomputed)."""
    from openset_rcnn_tpu_torch.models.resnet import STAGE_BLOCKS

    n = trunk_bn_launches(cfg)
    if n and cfg.TPU.REMAT:
        trained = STAGE_BLOCKS[cfg.MODEL.RESNETS.DEPTH][max(cfg.MODEL.BACKBONE.FREEZE_AT - 1, 0):]
        n += 3 * sum(trained)
    return n


def repeat_step(torch, trainer, batch):
    """Two Trainer.steps from one state (parameters, momentum, step count)
    on one batch: (parameter tensors, the names of those that differ
    between the two, the largest absolute difference)."""
    import copy

    state = trainer.state
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    momentum = copy.deepcopy(state.optimizer.state_dict())
    step = state.step
    trainer.step(batch)
    first = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state.model.load_state_dict(params)
    state.optimizer.load_state_dict(momentum)
    state.step = step
    trainer.step(batch)
    torch.cuda.synchronize()
    second = {n: p.detach() for n, p in state.model.named_parameters()}
    differ = [n for n, p in first.items() if not torch.equal(p, second[n])]
    worst = max((float((first[n] - second[n]).abs().max()) for n in differ), default=0.0)
    return len(first), differ, worst


def phase_roi_align_window(torch, dev):
    """K5 at the serving shapes, f32 and bf16 features; then its path: one
    call on the f32 features with the counts at 0 just before."""
    from openset_rcnn_tpu_torch.ops.roi_align import (
        assign_levels, assign_levels_window_fit, roi_align_window, roi_align_window_plain)

    g = torch.Generator(device=dev).manual_seed(7)
    H, W = BUCKET
    R = 4 * 1000 + math.ceil(H / 64) * math.ceil(W / 64)
    C = 256
    feats32 = [torch.randn(BATCH, math.ceil(H / s), math.ceil(W / s), C, generator=g, device=dev) for s in STRIDES]
    boxes = roi_boxes(torch, g, BATCH, R, dev)
    levels = assign_levels_window_fit(boxes, STRIDES)
    bumped = int((levels != assign_levels(boxes)).sum())
    check(bumped > 0, "roi_align_window: the window-fit rule moved no RoI")
    entry = dict(name="roi_align_window", route="cuda", source="openset_rcnn_tpu_torch/csrc/roi_align_fwd.cu",
                 replaces="openset_rcnn_tpu/ops/pallas/roi_align_kernel.py:177")
    for dtype in (torch.float32, torch.bfloat16):
        feats = [f.to(dtype) for f in feats32]
        got = roi_align_window(feats, boxes, STRIDES)
        want = roi_align_window_plain(feats, boxes, STRIDES)
        torch.cuda.synchronize()
        check(got.dtype == dtype, f"roi_align_window: output {got.dtype} from {dtype} features")
        err = (got.float() - want.float()).abs()
        max_abs = float(err.max())
        atol, rtol = (ATOL, RTOL) if dtype == torch.float32 else (1e-6, BF16_STEP)
        check(bool((err <= atol + rtol * want.float().abs()).all()),
              f"roi_align_window {dtype} kernel vs plain: max abs {max_abs}")
        ms = time_ms(torch, lambda: roi_align_window(feats, boxes, STRIDES), 20)
        plain_ms = time_ms(torch, lambda: roi_align_window_plain(feats, boxes, STRIDES), 2)
        size = feats[0].element_size()
        bytes_moved = got.numel() * size + sum(f.numel() * size for f in feats) + boxes.numel() * 4
        bound_ms, bound_by = bound(bytes_moved, got.numel() * ROI_FLOPS_PER_OUTPUT)
        name = str(dtype).replace("torch.", "")
        print(f"roi_align_window ({name} features): B={BATCH} R={R} C={C}, {bumped} RoIs moved up a level by "
              f"the window-fit rule; max abs err {max_abs:.3e} (limit {atol} + {rtol} * |want|); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{bytes_moved / 1e9:.3f} GB)", flush=True)
        figures = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=None)
        if dtype == torch.float32:
            entry.update(figures)
        else:
            entry["bf16_features"] = figures
        del got, want
    # its path: the op called as a user calls it
    reset_launches()
    roi_align_window(feats32, boxes, STRIDES)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {name: 0 for name in launches}
    want["roi_align_window"] = 1
    check(launches == want, f"roi_align_window path launches {launches}, expected {want}")
    return entry, launches


def cuda_graph(torch, fn):
    """fn() captured as a CUDA graph, after one call on a side stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def phase_frozen_bn(torch, dev):
    """The FrozenBN kernel at the frame cell's shapes: the 49 calls of a bf16
    ResNet-50 forward on one 832x1344 image (channels_last, seeded weights,
    random statistics), recorded with their activations; each call's output
    bitwise the plain version's; one frame's 49 calls timed as a CUDA graph
    (as a Predictor replays them) on the kernel and on the plain version,
    the kernel's device time by the profiler, beside the bytes' bound."""
    from openset_rcnn_tpu_torch.models.resnet import FrozenBN, ResNet
    from openset_rcnn_tpu_torch.ops import frozen_bn

    model = ResNet(50, compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    for bn in (m for m in model.modules() if isinstance(m, FrozenBN)):
        bn.scale.uniform_(0.2, 0.6, generator=g)
        bn.bias.normal_(0, 0.5, generator=g)
        bn.mean.normal_(0, 0.5, generator=g)
        bn.var.uniform_(0.5, 4.0, generator=g)
    model = model.to(dev, memory_format=torch.channels_last)
    image = torch.randn(1, 3, *BUCKET, generator=g).to(dev).contiguous(memory_format=torch.channels_last)
    op, plain = frozen_bn.frozen_bn_act_op, frozen_bn.frozen_bn_act_plain
    calls = []

    def recording(*args):
        calls.append(args)
        return op(*args)

    frozen_bn.frozen_bn_act_op = recording
    try:
        with torch.no_grad():
            model(image)
    finally:
        frozen_bn.frozen_bn_act_op = op
    check(len(calls) == 49, f"frozen_bn_act: a ResNet-50 forward made {len(calls)} calls, expected 49")
    n_bytes = 0
    for args in calls:
        x, r = args[0], args[6]
        got, want = op(*args), plain(*args)
        same = got.view(torch.int16) == want.view(torch.int16)
        check(bool(same.all()) and got.stride() == x.stride(),
              f"frozen_bn_act vs plain at {tuple(x.shape)}: {int((~same).sum())} of {same.numel()} differ")
        n_bytes += x.numel() * x.element_size() * (3 if r is not None else 2)
    frame_ms = {label: time_ms(torch, cuda_graph(torch, lambda: [fn(*a) for a in calls]).replay, 20)
                for label, fn in (("kernel", op), ("plain", plain))}
    launch_ms = device_ms(torch, lambda: [op(*a) for a in calls], 5, ("frozen_bn_act",))["frozen_bn_act"]
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"frozen_bn_act: R50 bf16 at {BUCKET[0]}x{BUCKET[1]}, batch 1, 49 calls a frame, bitwise the plain "
          f"version; per frame (CUDA graph of the 49 calls): kernel {frame_ms['kernel']:.4f} ms (device time "
          f"{49 * launch_ms:.4f} ms), plain {frame_ms['plain']:.4f} ms, bound {bound_ms:.4f} ms (bytes, "
          f"{n_bytes / 1e9:.3f} GB)", flush=True)
    return dict(name="frozen_bn_act", route="cuda", source="openset_rcnn_tpu_torch/csrc/frozen_bn_act.cu",
                replaces="none: XLA fused FrozenBN's affine (openset_rcnn_tpu/models/resnet.py)",
                max_abs_err=0.0, ms=frame_ms["kernel"], plain_ms=frame_ms["plain"], bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, device_ms=49 * launch_ms)


def phase_roi_align_bwd_bf16(torch, dev):
    """K2's pallas_bf16 mode at the production training shapes."""
    from openset_rcnn_tpu_torch.ops.roi_align import (
        assign_levels, roi_align_bwd, roi_align_bwd_bf16, roi_align_bwd_plain)

    g = torch.Generator(device=dev).manual_seed(8)
    B, R, C, P, S = TRAIN_BATCH_BF16, TRAIN_ROIS, 256, 7, 2
    H, W = BUCKET
    level_hw = [(math.ceil(H / s), math.ceil(W / s)) for s in STRIDES]
    boxes = roi_boxes(torch, g, B, R, dev)
    levels = assign_levels(boxes)  # the production config's levels (TPU.ROI_ALIGN_IMPL auto)
    cot = torch.randn(B, R, P, P, C, generator=g, device=dev)
    got = roi_align_bwd_bf16(cot, boxes, levels, level_hw, STRIDES, P, S)
    want = roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, S, acc_dtype=torch.bfloat16)
    f32 = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, S)
    torch.cuda.synchronize()
    check(all(a.dtype == torch.bfloat16 for a in got), "roi_align_bwd_bf16: accumulators are not bf16")
    scale = max(1.0, max(float(w.float().abs().max()) for w in want))
    max_abs = max_excess = 0.0
    for a, w, f in zip(got, want, f32):
        err = (a.float() - w.float()).abs()
        max_abs = max(max_abs, float(err.max()))
        max_excess = max(max_excess, float((err - BF16_ACC_RTOL * w.float().abs()).max()))
        check(bool((err <= BF16_ACC_ATOL * scale + BF16_ACC_RTOL * w.float().abs()).all()),
              f"roi_align_bwd_bf16 kernel vs plain: max abs {float(err.max())}")
        check(bool(((a.float() - f).abs() <= 5e-2 + 3e-2 * f.abs()).all()),
              "roi_align_bwd_bf16 kernel vs the f32 kernel: outside rtol 3e-2, atol 5e-2")
    again = roi_align_bwd_bf16(cot, boxes, levels, level_hw, STRIDES, P, S)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), "roi_align_bwd_bf16: two launches differ")
    del again, f32
    # RoIs clustered around 20 GT boxes per image: hot tiles
    boxes_c = clustered_boxes(torch, g, B, R, dev)
    levels_c = assign_levels(boxes_c)
    got_c = roi_align_bwd_bf16(cot, boxes_c, levels_c, level_hw, STRIDES, P, S)
    want_c = roi_align_bwd_plain(cot, boxes_c, levels_c, level_hw, STRIDES, P, S, acc_dtype=torch.bfloat16)
    again = roi_align_bwd_bf16(cot, boxes_c, levels_c, level_hw, STRIDES, P, S)
    check(all(torch.equal(a, b) for a, b in zip(got_c, again)), "roi_align_bwd_bf16 (clustered): two launches differ")
    scale_c = max(1.0, max(float(w.float().abs().max()) for w in want_c))
    max_abs_c = 0.0
    for a, w in zip(got_c, want_c):
        err = (a.float() - w.float()).abs()
        max_abs_c = max(max_abs_c, float(err.max()))
        check(bool((err <= BF16_ACC_ATOL * scale_c + BF16_ACC_RTOL * w.float().abs()).all()),
              f"roi_align_bwd_bf16 (clustered) kernel vs plain: max abs {float(err.max())}")
    del got_c, want_c, again
    clustered_ms = time_ms(torch, lambda: roi_align_bwd_bf16(cot, boxes_c, levels_c, level_hw, STRIDES, P, S), 20)
    ms = time_ms(torch, lambda: roi_align_bwd_bf16(cot, boxes, levels, level_hw, STRIDES, P, S), 20)
    f32_ms = time_ms(torch, lambda: roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, S), 20)
    plain_ms = time_ms(torch, lambda: roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, S,
                                                           acc_dtype=torch.bfloat16), 1)
    acc_bytes = sum(w.numel() * 2 for w in want)
    n_bytes = cot.numel() * 4 + boxes.numel() * 4 + levels.numel() * 4 + acc_bytes
    bound_ms, bound_by = bound(n_bytes, cot.numel() * (S * S * ROI_BWD_FLOPS_PER_SAMPLE + 1))
    per_level = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    print(f"roi_align_bwd_bf16: B={B} R={R} C={C} RoIs per level {per_level}; bf16 accumulators "
          f"{acc_bytes / 1e9:.3f} GB (f32: {2 * acc_bytes / 1e9:.3f} GB); max abs err vs plain {max_abs:.3e} "
          f"(limit {BF16_ACC_ATOL * scale:.3e} + {BF16_ACC_RTOL} * |want|, worst excess over the relative part "
          f"{max_excess:.3e}); two launches bitwise equal; kernel {ms:.4f} ms, f32 kernel at these shapes {f32_ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e9:.3f} GB)", flush=True)
    print(f"roi_align_bwd_bf16, RoIs clustered around 20 GT boxes per image: RoIs per level "
          f"{torch.bincount(levels_c.flatten().long(), minlength=4).tolist()}; max abs err vs plain {max_abs_c:.3e} "
          f"(limit {BF16_ACC_ATOL * scale_c:.3e} + {BF16_ACC_RTOL} * |want|); two launches bitwise equal; kernel "
          f"{clustered_ms:.4f} ms", flush=True)
    return dict(name="roi_align_bwd_bf16", route="cuda", source="openset_rcnn_tpu_torch/csrc/roi_align_bwd.cu",
                replaces="openset_rcnn_tpu/ops/pallas/roi_align_v2.py:487", max_abs_err=max_abs,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                f32_kernel_ms_same_shapes=f32_ms,
                clustered=dict(ms=clustered_ms, max_abs_err=max_abs_c))


def device_busy_ms(prof):
    """The union of the device activity's intervals in a finished profile."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(bool(spans), "profile: the profiler saw no device activity")
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy_us, lo, hi = busy_us + hi - lo, s, e
        else:
            hi = max(hi, e)
    return (busy_us + hi - lo) / 1e3


def profile_step(torch, step):
    """One step under torch.profiler: the device's busy time (the union of
    its kernels' intervals) against the step's span on CUDA events, and the
    device time by kernel name (the top ones and the port's own)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    busy_ms = device_busy_ms(prof)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), key=lambda kv: -kv[1])
    own = {name: sum(ms for key, ms in kernels if name in key)
           for name in ("roi_align_fwd_kernel", "roi_align_bwd_kernel", "roi_align_bwd_bf16_kernel",
                        "iou_match_best_kernel", "iou_match_rescue_kernel", "nms_iou_mask_kernel", "nms_walk_kernel")}
    return dict(step_ms=step_ms, device_busy_ms=busy_ms, idle_share=max(0.0, 1.0 - busy_ms / step_ms),
                kernel_ms_total=sum(ms for _, ms in kernels), own_kernels_ms=own,
                top_kernels_ms=[[key[:60], round(ms, 3)] for key, ms in kernels[:8]])


def eval_records(np, hw=EVAL_HW):
    """The eval phase's records and their decoded pixels: 28 landscape
    800x1200 and 16 portrait 1200x800 images (in a seeded order), colored
    rectangles on a noisy background, with 2-6 GT boxes over the VOC-COCO
    classes (the first known, the second unknown, the rest either). The test
    transform keeps these sizes (resize_shortest_edge(800, 1200, 800, 1333)
    is (800, 1200)), so no image is resized."""
    rng = np.random.RandomState(11)
    shapes = [hw] * EVAL_LANDSCAPE + [hw[::-1]] * EVAL_PORTRAIT
    records, pixels = [], {}
    for i in rng.permutation(len(shapes)):
        h, w = shapes[i]
        img = rng.randint(20, 60, (h, w, 3)).astype(np.uint8)
        annos = []
        for j in range(rng.randint(2, 7)):
            bw, bh = rng.randint(w // 10, w // 2), rng.randint(h // 10, h // 2)
            x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            img[y1:y1 + bh, x1:x1 + bw] = rng.randint(60, 255, 3)
            cls = rng.randint(0, 20) if j == 0 else rng.randint(20, 80) if j == 1 else rng.randint(0, 80)
            annos.append({"bbox": [float(x1), float(y1), float(x1 + bw), float(y1 + bh)],
                          "category_id": int(cls), "difficult": 0})
        name = f"memory://{int(i)}"
        pixels[name] = img
        records.append({"file_name": name, "image_id": int(i), "height": h, "width": w, "annotations": annos})
    return records, pixels


def register_eval(name, records):
    from openset_rcnn_tpu_torch.data import DatasetCatalog, MetadataCatalog, VOC_COCO_CATEGORIES

    DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: records)
    MetadataCatalog.get(name).update(evaluator_type="voc_records", thing_classes=VOC_COCO_CATEGORIES)


def in_memory_transform(cfg, pixels):
    """The test transform of ``cfg`` reading decoded pixels from memory (the
    card's machine has no image decoder)."""
    from openset_rcnn_tpu_torch.engine.train_loop import build_test_transform

    transform = build_test_transform(cfg)
    transform.read_image = lambda record: pixels[record["file_name"]]
    return transform


def phase_eval(torch, dev, cfg, cfg32, serve_img_per_s):
    """The evaluation path (see the module docstring, phase 13)."""
    import numpy as np
    from openset_rcnn_tpu_torch import _native
    from openset_rcnn_tpu_torch.data import EvalLoader, device_prefetch
    from openset_rcnn_tpu_torch.engine.train_loop import do_test, get_evaluator
    from openset_rcnn_tpu_torch.evaluation import evalcore_binding
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor
    from openset_rcnn_tpu_torch.evaluation.postprocess import finalize_serve_image, postprocess_image
    from openset_rcnn_tpu_torch.evaluation.testing import RAW_FIELDS, SERVE_FIELDS, inference_on_dataset, to_host

    voc_keys = ("mAP", "WI", "AOSE", "AP@K", "P@K", "R@K", "AP@U", "P@U", "R@U")
    t0 = time.perf_counter()
    records, pixels = eval_records(np, EVAL_HW)
    register_eval(EVAL_DATASET, records)
    transform = in_memory_transform(cfg, pixels)
    batch_size = cfg.TPU.EVAL_BATCH_SIZE
    batches = list(EvalLoader(records, transform, batch_size))
    shapes = [(tuple(b.images.shape), len(m.image_ids)) for b, m in batches]
    land, port = (batch_size, *cfg.TPU.TEST_BUCKET, 3), (batch_size, *cfg.TPU.TEST_BUCKET[::-1], 3)
    check(sorted(shapes) == sorted([(land, batch_size)] * 3 + [(land, 4), (port, batch_size), (port, batch_size)]),
          f"eval: batches {shapes}, expected three full landscape, a padded one of 4 and two full portrait")
    check(all(m.input_hw == m.original_hw for _, m in batches), "eval: an image was resized")
    print(f"eval: {len(records)} records made and batched in {time.perf_counter() - t0:.1f} s; batches "
          f"(shape, real images) {shapes}; native evalcore built and loaded: {evalcore_binding.available()} "
          f"({_native.library_path('evalcore')})", flush=True)

    # the main path, through the user's entry point: counts at 0 just before, read just after
    reset_launches()
    with predict_calls() as calls:
        metrics = do_test(cfg, datasets=[EVAL_DATASET], transform=transform)[EVAL_DATASET]
        torch.cuda.synchronize()
    launches = read_launches()
    n_batches = len(batches)
    # per bucket one eager call and one capture; the later batches replay
    want_calls = {"predict.eager": 2, "predict.graph.capture": 2, "predict.graph.replay": n_batches - 4}
    check(calls == want_calls, f"eval: Predictor's calls {calls}, expected {want_calls}")
    want = {name: 0 for name in launches}
    want.update(roi_align_fwd=wrapper_calls(calls), nms_keep=2 * wrapper_calls(calls),
                frozen_bn_act=trunk_bn_launches(cfg) * wrapper_calls(calls))
    check(launches == want, f"eval launches {launches}, expected {want}")
    check(set(metrics) == set(voc_keys) and all(math.isfinite(v) for v in metrics.values()),
          f"eval (do_test, fused): metrics {metrics}, expected finite values of {voc_keys}")
    print(f"eval: do_test on {EVAL_DATASET} ({cfg.TPU.DTYPE}, fused cascade), {len(records)} images: "
          + json.dumps(metrics) + "; Predictor's calls " + json.dumps(calls) + "; wrapper launches (eager and "
          "capturing calls) " + json.dumps(launches), flush=True)

    # the loop timed: one warm pass, then one timed pass and one profiled pass
    predictor = Predictor(cfg, seed=0)

    def run(timings=None):
        evaluator = get_evaluator(cfg, EVAL_DATASET)
        return inference_on_dataset(predictor, EvalLoader(records, transform, batch_size), evaluator,
                                    timings=timings)

    check(run() == metrics, "eval: a second Predictor gives other metrics than do_test's")
    timings = {}
    torch.cuda.synchronize()
    run(timings)
    eval_img_per_s = timings["images"] / timings["seconds"]
    profile = profile_step(torch, run)

    # Predictor alone on the loader's first landscape batch, on the device, in this run
    images, image_hw = batches[0][0].images.to(dev), batches[0][0].image_hw.to(dev)
    alone_ms = time_ms(torch, lambda: predictor(images, image_hw), SERVE_BATCHES)
    # no hidden host sync inside a batch: the forward, the cascade and the copies' enqueue
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        host = to_host(predictor(images, image_hw), SERVE_FIELDS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host.numpy()
    consume = timings["consume_ms"]
    print(f"eval: {eval_img_per_s:.2f} img/s over the whole loop ({timings['images']} images in "
          f"{timings['seconds'] * 1e3:.1f} ms), Predictor alone {BATCH * 1e3 / alone_ms:.2f} img/s on one batch "
          f"({alone_ms:.2f} ms/batch; serve_bf16 phase {serve_img_per_s:.2f} img/s); host ms per batch in consume "
          f"{[round(x, 2) for x in consume]} (waiting for the copies {[round(x, 2) for x in timings['wait_ms']]}); "
          f"one batch under set_sync_debug_mode('error') made no host sync", flush=True)
    # the profiler slows the host side of the loop (the loader thread's copies, each launch), so its idle
    # share overstates the idle time; its device busy time against the unprofiled loop's span does not
    idle_unprofiled = max(0.0, 1.0 - profile["device_busy_ms"] / (timings["seconds"] * 1e3))
    print(f"eval: device idle share {profile['idle_share']:.3f} in the profiled pass, {idle_unprofiled:.3f} of the "
          f"timed pass (the profiled pass's device busy time over the timed pass's span)", flush=True)
    print("eval profile: " + json.dumps(profile), flush=True)

    # f32: fused cascade (K4) against the exact host cascade on the same raw outputs
    transform32 = in_memory_transform(cfg32, pixels)
    predictor32 = Predictor(cfg32, seed=0)
    post_cfg = predictor32.post_cfg
    evaluators = {k: get_evaluator(cfg32, EVAL_DATASET) for k in ("fused", "host", "host_all")}
    compared = overflowed = n_dets = 0
    worst = 0.0
    for batch, meta in device_prefetch(EvalLoader(records, transform32, batch_size), dev):
        raw = predictor32.raw(batch.images, batch.image_hw)
        fused = to_host(predictor32.cascade(raw), SERVE_FIELDS).numpy()
        raw = to_host(raw, RAW_FIELDS).numpy()
        for i, image_id in enumerate(meta.image_ids):
            args = (meta.input_hw[i], meta.original_hw[i], post_cfg)
            host = postprocess_image(*(raw[k][i] for k in RAW_FIELDS), *args)
            evaluators["host_all"].process(image_id, host.boxes, host.scores, host.classes)
            if fused["known_overflow"][i] > 0:
                overflowed += 1
                continue
            fin = finalize_serve_image(*(fused[k][i] for k in ("boxes", "scores", "classes", "valid")), *args)
            check(len(fin.classes) == len(host.classes), f"eval f32 image {image_id}: fused {len(fin.classes)} "
                  f"detections, host {len(host.classes)}")
            a = np.concatenate([fin.classes[:, None], fin.scores[:, None], fin.boxes], 1).astype(np.float64)
            b = np.concatenate([host.classes[:, None], host.scores[:, None], host.boxes], 1).astype(np.float64)
            a, b = a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])]
            check(np.array_equal(a[:, 0], b[:, 0]), f"eval f32 image {image_id}: classes differ")
            if len(b):
                err = float(np.abs(a[:, 1:] - b[:, 1:]).max()) / max(1.0, float(np.abs(b[:, 1:]).max()))
                check(err <= EVAL_TOL, f"eval f32 image {image_id}: fused vs host scaled error {err:.3e}")
                worst = max(worst, err)
            evaluators["fused"].process(image_id, fin.boxes, fin.scores, fin.classes)
            evaluators["host"].process(image_id, host.boxes, host.scores, host.classes)
            compared += 1
            n_dets += len(b)
    check(compared > 0, "eval f32: every image overflowed the known-candidate slot")
    fused_metrics, host_metrics = evaluators["fused"].evaluate(), evaluators["host"].evaluate()
    check(fused_metrics == host_metrics, f"eval f32: VOC metrics fused {fused_metrics} != host {host_metrics}")
    host_all = evaluators["host_all"].evaluate()
    cfg32_host = cfg32.clone()
    cfg32_host.TPU.EVAL_FUSED = False
    via_do_test = do_test(cfg32_host, datasets=[EVAL_DATASET], transform=transform32)[EVAL_DATASET]
    check(via_do_test == host_all, f"eval f32: do_test with EVAL_FUSED false {via_do_test} != the host cascade's "
          f"{host_all}")
    print(f"eval f32: fused cascade (K4) == host cascade on {compared} images without overflow ({n_dets} "
          f"detections, worst scaled error {worst:.3e}, limit {EVAL_TOL}; {overflowed} images overflowed and were "
          f"left out), equal VOC metrics " + json.dumps(fused_metrics)
          + "; do_test with TPU.EVAL_FUSED false == the host cascade over all images " + json.dumps(via_do_test),
          flush=True)

    # proposals over two batches
    register_eval(EVAL_DATASET + "_proposals", [r for r in records if r["width"] > r["height"]][:2 * batch_size])
    ar = do_test(cfg32, datasets=[EVAL_DATASET + "_proposals"], eval_type="proposals",
                 transform=transform32)[EVAL_DATASET + "_proposals"]
    check({"AR@100", "AR@1000"} <= set(ar) and all(math.isfinite(ar[k]) for k in ("AR@100", "AR@1000")),
          f"eval proposals: {ar}")
    print("eval proposals (f32, two batches): " + json.dumps(ar), flush=True)
    return launches, dict(metrics=metrics, img_per_s=eval_img_per_s, predictor_alone_img_per_s=BATCH * 1e3 / alone_ms,
                          consume_ms=consume, wait_ms=timings["wait_ms"], device_idle_share=profile["idle_share"],
                          device_idle_share_unprofiled=idle_unprofiled,
                          fused_vs_host=dict(images=compared, overflowed=overflowed, detections=n_dets,
                                             worst_scaled_err=worst, metrics=fused_metrics),
                          proposals=ar)


def phase_parity_eval(torch, dev, cfg):
    """do_test on the parity config (f32, gather levels, the adaptive grid,
    the host cascade) over the eval phase's records at full width: every
    batch through K1's adaptive mode and the trunk's FrozenBN kernel, no
    other kernel; img/s of the whole
    call and of its inference_on_dataset loop alone (no model build)."""
    import numpy as np
    from openset_rcnn_tpu_torch.engine.train_loop import do_test
    from openset_rcnn_tpu_torch.evaluation import testing

    check(cfg.TPU.ROI_SAMPLING_RATIO == ADAPTIVE and not cfg.TPU.EVAL_FUSED and cfg.TPU.DTYPE == "float32",
          "the parity config is not f32 with the adaptive grid and the host cascade")
    records, pixels = eval_records(np, EVAL_HW)
    register_eval(EVAL_DATASET, records)
    transform = in_memory_transform(cfg, pixels)
    do_test(cfg, datasets=[EVAL_DATASET], transform=transform)  # warm: the model, cuDNN, the kernel library
    torch.cuda.synchronize()
    # do_test's loop, timed apart from the model build by inference_on_dataset's own timings
    loop, inference_on_dataset = {}, testing.inference_on_dataset

    def timed_loop(*args, **kwargs):
        torch.cuda.synchronize()
        return inference_on_dataset(*args, **kwargs, timings=loop)

    testing.inference_on_dataset = timed_loop
    try:
        reset_launches()
        t0 = time.perf_counter()
        metrics = do_test(cfg, datasets=[EVAL_DATASET], transform=transform)[EVAL_DATASET]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    finally:
        testing.inference_on_dataset = inference_on_dataset
    check(loop.get("images") == len(records), f"parity eval: the loop's timings {loop}")
    n_batches = sum(math.ceil(n / cfg.TPU.EVAL_BATCH_SIZE) for n in (EVAL_LANDSCAPE, EVAL_PORTRAIT))
    want = {name: 0 for name in launches}
    want.update(roi_align_fwd_adaptive=n_batches, frozen_bn_act=trunk_bn_launches(cfg) * n_batches)
    check(launches == want, f"parity eval launches {launches}, expected {want}")
    check(all(math.isfinite(v) for v in metrics.values()) and {"WI", "AOSE", "mAP"} <= set(metrics),
          f"parity eval: metrics {metrics}")
    print(f"parity eval: do_test on {EVAL_DATASET} (configs/VOC-COCO/{CONFIG_PARITY.name}: f32, gather levels, "
          f"adaptive grid, host cascade), {len(records)} images in {n_batches} batches: "
          f"{loop['images'] / loop['seconds']:.2f} img/s over the inference_on_dataset loop "
          f"({loop['seconds'] * 1e3:.1f} ms), {len(records) / seconds:.2f} img/s over the whole call "
          f"({seconds * 1e3:.1f} ms, model build included); " + json.dumps(metrics)
          + "; launches " + json.dumps(launches), flush=True)
    return launches, dict(metrics=metrics, img_per_s=loop["images"] / loop["seconds"], loop_seconds=loop["seconds"],
                          call_img_per_s=len(records) / seconds, seconds=seconds, batches=n_batches)


def register_records(name, records):
    from openset_rcnn_tpu_torch.data import DatasetCatalog, MetadataCatalog, VOC_COCO_CATEGORIES

    DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: records)
    MetadataCatalog.get(name).update(evaluator_type="voc_records", thing_classes=VOC_COCO_CATEGORIES)


def phase_do_train(torch, dev, step_alone_img_per_s):
    """``python -m openset_rcnn_tpu_torch.train`` as a user runs it, in this
    process (``main``), on the production config at full width, its batch
    16 and the 832x1344 bucket: synthetic records written to a temporary
    directory (removed at the end) and registered in the catalog,
    ``MODEL.WEIGHTS`` a port checkpoint of a seeded init with FrozenBN
    calibrated on the loader's first batch (from a raw random trunk the
    production LR diverges), MAX_ITER 6 with a checkpoint and an eval every
    3, then ``--resume`` to 8. Gates: finite losses, the metrics.json
    iterations, the checkpoints, the resumed step, and K1, K2 bf16, K3 and
    K4 launched. Then ``--resume`` to 20 without evals: the loop's img/s
    from CUDA events at the start of each steady step, beside Trainer.step
    alone; its last two steps under torch.profiler give the device idle
    share, profiled and as their busy time against the span of two
    unprofiled steps (the profiler slows the loader's threads)."""
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_do_train_"))
    try:
        return do_train_run(torch, dev, step_alone_img_per_s, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def do_train_run(torch, dev, step_alone_img_per_s, work):
    """The runs of ``phase_do_train``, with their records, weights and
    output under ``work``."""
    from openset_rcnn_tpu_torch import train as cli
    from openset_rcnn_tpu_torch.data import TrainLoader, generate_synthetic_dataset
    from openset_rcnn_tpu_torch.engine import train_state
    from openset_rcnn_tpu_torch.engine.train_loop import build_train_transform
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, build_model
    from torch.profiler import ProfilerActivity, profile

    train_name, test_name = "chip_smoke_train", "chip_smoke_test"
    t0 = time.perf_counter()
    n_land, n_port, n_test = DO_TRAIN_RECORDS
    land = generate_synthetic_dataset(str(work / "land"), n_land, EVAL_HW, num_classes=80, max_objects=6, seed=21)
    port = generate_synthetic_dataset(str(work / "port"), n_port, EVAL_HW[::-1], num_classes=80, max_objects=6,
                                      seed=22)
    for i, r in enumerate(port):
        r["image_id"] = n_land + i
    test = generate_synthetic_dataset(str(work / "test"), n_test, EVAL_HW, num_classes=80, max_objects=6, seed=23)
    register_records(train_name, land + port)
    register_records(test_name, test)

    cfg = load_cfg(CONFIG_BF16)
    batch_size = cfg.SOLVER.IMS_PER_BATCH
    check(batch_size == TRAIN_BATCH_BF16 and tuple(cfg.TPU.TRAIN_BUCKET) == BUCKET,
          f"the production config trains at batch {batch_size} on {cfg.TPU.TRAIN_BUCKET}")
    cfg.DATASETS.TRAIN = (train_name,)
    first, _ = next(iter(TrainLoader(land + port, build_train_transform(cfg), batch_size, seed=0)))
    model = build_model(ModelSpec.from_cfg(cfg), dev, seed=0)
    calibrated = calibrate_frozen_bn(torch, model, first.images.to(dev), first.image_hw.to(dev))
    weights = work / "init.pt"
    torch.save({"model": model.state_dict()}, weights)
    del model
    torch.cuda.empty_cache()
    out = work / "run"
    # flags first: KEY VALUE pairs take the rest of the command line
    argv = ["SEED", "0", "OUTPUT_DIR", str(out), "MODEL.WEIGHTS", str(weights), "MODEL.RPN.DELTA_BIAS_INIT", "1.0",
            "DATASETS.TRAIN", f"('{train_name}',)", "DATASETS.TEST", f"('{test_name}',)"]
    periods = ["SOLVER.CHECKPOINT_PERIOD", str(DO_TRAIN_PERIOD), "TEST.EVAL_PERIOD", str(DO_TRAIN_PERIOD)]
    print(f"do_train: {n_land} + {n_port} train and {n_test} test records written ({EVAL_HW[0]}x{EVAL_HW[1]} and "
          f"{EVAL_HW[1]}x{EVAL_HW[0]} PNGs), {calibrated} FrozenBN statistics calibrated on the loader's first "
          f"batch, weights saved in {time.perf_counter() - t0:.1f} s", flush=True)

    # each step's start: an event on the device's timeline, the host clock, the step count
    starts, window = [], {}
    step = train_state.Trainer.step
    profiled_from = DO_TRAIN_TIMED_ITERS - DO_TRAIN_PROFILED

    def timed(self, batch, *args, **kwargs):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        starts.append((self.state.step, event, time.perf_counter()))
        if self.state.step == profiled_from:  # the timed run's last steps, under the profiler
            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["start"] = event
        metrics = step(self, batch, *args, **kwargs)
        if self.state.step == DO_TRAIN_TIMED_ITERS:
            window["end"] = torch.cuda.Event(enable_timing=True)
            window["end"].record()
            torch.cuda.synchronize()
            window["prof"].__exit__(None, None, None)
        return metrics

    def run(*flags, max_iter):
        state = cli.main(cli.get_parser().parse_args(
            ["--config-file", str(CONFIG_BF16), *flags, *argv, "SOLVER.MAX_ITER", str(max_iter)]))
        torch.cuda.synchronize()
        return state

    reset_launches()
    train_state.Trainer.step = timed
    try:
        wall = time.perf_counter()
        state = run(*periods, max_iter=DO_TRAIN_ITERS)
        wall = time.perf_counter() - wall
        check(state.step == DO_TRAIN_ITERS, f"do_train stopped at {state.step}")
        first_run = list(starts)
        state = run("--resume", *periods, max_iter=DO_TRAIN_RESUME_ITERS)
        launches = read_launches()
        resumed = starts[len(first_run):]

        lines = [json.loads(line) for line in open(out / "metrics.json")]
        iterations = [line["iteration"] for line in lines]
        check(iterations == [1, DO_TRAIN_PERIOD, DO_TRAIN_ITERS, DO_TRAIN_ITERS + 1, DO_TRAIN_RESUME_ITERS],
              f"do_train: metrics.json iterations {iterations}")
        eval_line = lines[1]
        check(f"{test_name}/mAP" in eval_line and all(math.isfinite(v) for v in eval_line.values()),
              f"do_train: the eval line {eval_line}")
        losses = [line["total_loss"] for line in lines if "total_loss" in line]
        check(len(losses) == 4 and all(math.isfinite(v) for v in losses), f"do_train: losses {losses}")
        saved = sorted(p.name for p in out.glob("model_*.pt"))
        want_saved = [f"model_{i:07d}.pt" for i in (DO_TRAIN_PERIOD, DO_TRAIN_ITERS, DO_TRAIN_RESUME_ITERS)]
        check(saved == want_saved and (out / "last_checkpoint").read_text() == want_saved[-1],
              f"do_train: checkpoints {saved}")
        check(resumed[0][0] == DO_TRAIN_ITERS and state.step == DO_TRAIN_RESUME_ITERS,
              f"do_train: resumed at step {resumed[0][0]}, ended at {state.step}")
        check([i for i, _, _ in first_run] == list(range(DO_TRAIN_ITERS)), "do_train: the first run's steps")
        check((out / "config.yaml").exists() and (out / "log.txt").stat().st_size > 0,
              "do_train: config.yaml, log.txt")
        for name in ("roi_align_fwd", "roi_align_bwd_bf16", "iou_match", "nms_keep", "frozen_bn_act"):
            check(launches[name] > 0, f"do_train: {name} was not launched ({launches})")

        # the timed run: no evals, a checkpoint only at its end
        del state
        torch.cuda.empty_cache()
        state = run("--resume", "SOLVER.CHECKPOINT_PERIOD", str(DO_TRAIN_TIMED_ITERS), "TEST.EVAL_PERIOD", "0",
                    max_iter=DO_TRAIN_TIMED_ITERS)
        timed_run = starts[len(first_run) + len(resumed):]
    finally:
        train_state.Trainer.step = step
    check([i for i, _, _ in timed_run] == list(range(DO_TRAIN_RESUME_ITERS, DO_TRAIN_TIMED_ITERS))
          and state.step == DO_TRAIN_TIMED_ITERS, f"do_train: the timed run's steps {[i for i, _, _ in timed_run]}")
    timed_iterations = [json.loads(line)["iteration"] for line in open(out / "metrics.json")][len(lines):]
    check(timed_iterations == [DO_TRAIN_RESUME_ITERS + 1, DO_TRAIN_TIMED_ITERS],
          f"do_train: the timed run's metrics.json iterations {timed_iterations}")

    # steady: from the second step's start to the first profiled step's
    steady = range(1, len(timed_run) - DO_TRAIN_PROFILED)
    step_ms = [timed_run[i][1].elapsed_time(timed_run[i + 1][1]) for i in steady]
    host_ms = [(timed_run[i + 1][2] - timed_run[i][2]) * 1e3 for i in steady]
    mean_ms = sum(step_ms) / len(step_ms)
    loop_img_per_s = batch_size * 1e3 / mean_ms
    span_ms = window["start"].elapsed_time(window["end"])
    busy_ms = device_busy_ms(window["prof"])
    idle = max(0.0, 1.0 - busy_ms / span_ms)
    idle_unprofiled = max(0.0, 1.0 - busy_ms / (DO_TRAIN_PROFILED * mean_ms))
    print(f"do_train (CLI, {CONFIG_BF16.name}, batch {batch_size}): metrics.json iterations "
          f"{iterations + timed_iterations}, checkpoints {saved} (and {DO_TRAIN_TIMED_ITERS} from the timed run), "
          f"resumed at step {resumed[0][0]} and at {timed_run[0][0]}; total_loss {[round(v, 4) for v in losses]}; "
          f"eval at {DO_TRAIN_PERIOD}: " + json.dumps({k: v for k, v in eval_line.items() if k != 'time'}),
          flush=True)
    print(f"do_train: loop {loop_img_per_s:.2f} img/s over {len(step_ms)} steady steps of the timed run "
          f"({len(step_ms) * batch_size} images; device ms from step start to step start "
          f"{[round(x, 2) for x in step_ms]}, host ms "
          f"{[round(x, 2) for x in host_ms]}) against Trainer.step alone {step_alone_img_per_s:.2f} img/s "
          f"(train_bf16 phase); first run {wall:.1f} s for {DO_TRAIN_ITERS} steps with build, weights, eval and "
          f"checkpoints; device idle share over the timed run's last {DO_TRAIN_PROFILED} steps {idle:.3f} profiled "
          f"(busy {busy_ms:.1f} of {span_ms:.1f} ms), {idle_unprofiled:.3f} against {DO_TRAIN_PROFILED} unprofiled "
          f"steady steps ({DO_TRAIN_PROFILED * mean_ms:.1f} ms); launches (first two runs) " + json.dumps(launches),
          flush=True)
    return launches, dict(loop_img_per_s=loop_img_per_s, step_ms=step_ms, host_ms=host_ms,
                          step_alone_img_per_s=step_alone_img_per_s, device_idle_share=idle,
                          device_idle_share_unprofiled=idle_unprofiled, first_run_s=wall,
                          iterations=iterations + timed_iterations, checkpoints=saved, losses=losses)


C2_BRANCH = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c", "shortcut": "branch1"}


def caffe2_backbone(torch, source):
    """(the caffe2 ImageNet-pkl entries of the backbone of the port state
    ``source``: each convolution, and its FrozenBN statistics fused into
    scale and bias as caffe2 keeps them; the port entries they load to:
    the same, with identity statistics)."""
    pkl, loads_to = {}, {}
    for key, weight in source.items():
        m = re.fullmatch(r"backbone\.(?:(res\d)_block(\d+)\.(conv\d|shortcut)|stem_conv)\.weight", key)
        if not m:
            continue
        if m[1]:
            name = bn_name = f"{m[1]}_{m[2]}_{C2_BRANCH[m[3]]}"
            bn = f"backbone.{m[1]}_block{m[2]}." + ("shortcut_bn" if m[3] == "shortcut" else f"bn{m[3][-1]}")
        else:
            name, bn_name, bn = "conv1", "res_conv1", "backbone.stem_bn"
        scale = source[f"{bn}.scale"] / torch.sqrt(source[f"{bn}.var"] + 1e-5)
        bias = source[f"{bn}.bias"] - source[f"{bn}.mean"] * scale
        pkl.update({f"{name}_w": weight.numpy(), f"{bn_name}_bn_s": scale.numpy(), f"{bn_name}_bn_b": bias.numpy()})
        loads_to.update({key: weight, f"{bn}.scale": scale, f"{bn}.bias": bias,
                         f"{bn}.mean": torch.zeros_like(scale), f"{bn}.var": torch.ones_like(scale)})
    return pkl, loads_to


def jax_flat(torch, state):
    """The JAX package's flat 'a/b/c' parameter names and layouts of a port
    R50-FPN state_dict (``utils/jax_params.py`` inverted: OIHW -> HWIO,
    (O, I) -> (I, O), ``weight`` -> ``kernel``): what its
    ``load_npz_into_params`` reads."""
    out = {}
    for key, value in state.items():
        value = value.numpy()
        *path, leaf = key.split(".")
        if leaf == "weight":
            value = value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T
            leaf = "kernel"
        out["/".join([*path, leaf])] = value
    return out


def state_equal(torch, got, want, keys=None):
    """The keys (of ``keys``, default all of ``want``) whose tensors differ."""
    return [k for k in (keys or want) if not torch.equal(got[k].cpu(), want[k].cpu())]


def phase_weights(torch, dev, work):
    """MODEL.WEIGHTS in the JAX package's formats, on the production config
    at full width: a seeded port model with FrozenBN calibrated on the serve
    batch is written as a d2 ``.pth`` (``torch_weights.to_d2``, fc1's
    columns back in CHW order), a caffe2 ``.pkl`` of its backbone (BN fused
    into scale and bias) and a JAX-layout ``.npz``; each loads through
    ``load_weights_file`` into a state dict bitwise equal to the source (the
    backbone, with identity statistics, for the ``.pkl``). Then the path:
    ``Predictor`` on ``MODEL.WEIGHTS x.pth`` at batch 8 against ``Predictor``
    on the state dict (bitwise, K1 1 and K4 2 launches a batch), and one
    ``Trainer`` step (batch 4, bench.py's batch) from the ``.pkl``-loaded
    weights against one from the same state dict (bitwise; K3, K1, K2)."""
    import pickle

    import numpy as np
    from openset_rcnn_tpu_torch.engine.checkpoint import Checkpointer, load_weights_file
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, build_model
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch
    from openset_rcnn_tpu_torch.utils.torch_weights import to_d2

    t0 = time.perf_counter()
    cfg = load_cfg(CONFIG_BF16)
    spec = ModelSpec.from_cfg(cfg)
    images, image_hw = serve_batch(torch, dev)
    model = build_model(spec, dev, seed=0)
    calibrate_frozen_bn(torch, model, images, image_hw.to(dev))
    source = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    paths = {"pth": work / "model_final.pth", "pkl": work / "R-50.pkl", "npz": work / "weights.npz"}
    torch.save({"model": {k: torch.from_numpy(v) for k, v in to_d2(source).items()}, "iteration": 0}, paths["pth"])
    caffe2, backbone = caffe2_backbone(torch, source)
    with open(paths["pkl"], "wb") as f:
        pickle.dump({"model": caffe2, "__author__": "chip_smoke"}, f)
    np.savez(paths["npz"], **jax_flat(torch, source))
    # the targets start from another init (seed 1), so a key that does not load shows;
    # what the .pkl loads to: its backbone over the target's own init
    fused = {**build_model(spec, "cpu", seed=1).state_dict(), **backbone}
    check(set(backbone) == {k for k in source if k.startswith("backbone.")}, "weights: the .pkl misses backbone keys")
    sizes = {k: p.stat().st_size / 1e6 for k, p in paths.items()}
    for kind, path in paths.items():
        target = build_model(spec, "cpu", seed=1)
        load_weights_file(str(path), target)
        want = fused if kind == "pkl" else source
        differ = state_equal(torch, target.state_dict(), want)
        check(not differ, f"weights: {kind} loaded {len(differ)} tensors unlike the source, e.g. {differ[:3]}")
    print(f"weights: the production model (FrozenBN calibrated) written as d2 .pth, caffe2 .pkl (backbone) and "
          f".npz ({json.dumps({k: round(v, 1) for k, v in sizes.items()})} MB); each loads through "
          f"load_weights_file bitwise to its source; {time.perf_counter() - t0:.1f} s", flush=True)

    from_pth = Predictor(cfg, seed=1)
    load_weights_file(str(paths["pth"]), from_pth.model)
    from_state = Predictor(cfg, state_dict=source)
    from_pth(images, image_hw)  # warm-up, eagerly
    from_state(images, image_hw)
    torch.cuda.synchronize()
    reset_launches()
    got = from_pth(images, image_hw)  # the capture: its wrappers launch once, into the graphs
    launches = read_launches()
    want = from_state(images, image_hw)
    torch.cuda.synchronize()
    expected = {name: 0 for name in launches}
    expected.update(roi_align_fwd=1, nms_keep=2, frozen_bn_act=trunk_bn_launches(cfg))
    check(launches == expected, f"weights: Predictor launches {launches}, expected {expected}")
    for name in got._fields:
        check(torch.equal(getattr(got, name), getattr(want, name)), f"weights: Predictor {name} from .pth != from state")
    del from_pth, from_state
    torch.cuda.empty_cache()

    host = bench_batch(torch, TRAIN_BATCH, cfg.TPU.MAX_GT_PER_IMAGE)
    batch = ImageBatch(host.images.to(dev), host.image_hw.to(dev),
                       GroundTruth(host.gt.boxes.to(dev), host.gt.classes.to(dev), host.gt.valid.to(dev)))
    a = Trainer(cfg, seed=1)
    Checkpointer(str(work / "output")).resume_or_load(a.state, str(paths["pkl"]), resume=False)
    differ = state_equal(torch, a.model.state_dict(), fused)
    check(not differ, f"weights: the .pkl-loaded Trainer differs from its state dict in {differ[:3]}")
    b = Trainer(cfg, state_dict=fused, seed=1)
    step_launches = {}
    for label, trainer in (("pkl", a), ("state", b)):
        reset_launches()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        step_launches[label] = read_launches()
        check(all(math.isfinite(float(v)) for v in metrics.values()), f"weights: non-finite {label} step metrics")
    fwd, bwd = train_kernels(cfg)
    expected = {name: 0 for name in launches}
    expected.update({fwd: 1, bwd: 1, "iou_match": 2, "frozen_bn_act": train_bn_launches(cfg)})
    check(step_launches["pkl"] == expected, f"weights: step launches {step_launches['pkl']}, expected {expected}")
    params_b = dict(b.model.named_parameters())
    differ = [n for n, p in a.model.named_parameters() if not torch.equal(p, params_b[n])]
    check(not differ, f"weights: the step from .pkl weights differs from the step from the state dict in {differ[:3]}")
    print(f"weights: Predictor on MODEL.WEIGHTS .pth == Predictor on the state dict, bitwise (batch {BATCH}, "
          f"{int(got.valid.sum())} detections); one Trainer step from the .pkl weights == one from the same state "
          f"dict, bitwise ({sum(1 for _ in a.model.parameters())} parameter tensors); launches per batch "
          f"{json.dumps(launches)}, per step {json.dumps(step_launches['pkl'])}", flush=True)
    del a, b
    torch.cuda.empty_cache()
    total = {k: launches[k] + step_launches["pkl"][k] for k in launches}
    return total, dict(sizes_mb=sizes, predictor_bitwise=True, step_bitwise=True), str(paths["pth"])


def phase_predict(torch, dev, work, weights):
    """``python -m openset_rcnn_tpu_torch.tools.predict`` in this process
    (``main``) with ``--viz`` on 8 synthetic 800x1200 JPEGs, the production
    config and ``MODEL.WEIGHTS`` the ``.pth`` of the weights phase: one JSON
    and one overlay per image, each JSON equal to ``Predictor`` +
    ``finalize_serve_image`` on the same decoded pixels, K1 and K4 launched
    (one image a batch). Prints the CLI's img/s (model build and weights
    included) beside ``Predictor`` alone on the same decoded images."""
    import cv2
    import numpy as np
    from openset_rcnn_tpu_torch.data import DetectionTransform
    from openset_rcnn_tpu_torch.engine.checkpoint import load_weights_file
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor
    from openset_rcnn_tpu_torch.evaluation.postprocess import PostprocessConfig, finalize_serve_image
    from openset_rcnn_tpu_torch.tools import predict

    rng = np.random.RandomState(31)
    inputs = work / "images"
    inputs.mkdir()
    for i in range(BATCH):
        # smooth blobs over noise: JPEG content with edges and flat regions
        img = cv2.GaussianBlur(rng.randint(0, 256, (*EVAL_HW, 3)).astype(np.uint8), (0, 0), 3 + i)
        cv2.imwrite(str(inputs / f"img{i}.jpg"), cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX))
    out = work / "predictions"
    argv = ["--config-file", str(CONFIG_BF16), "--input", str(inputs), "--output", str(out), "--viz",
            "MODEL.WEIGHTS", weights, "MODEL.RPN.DELTA_BIAS_INIT", "1.0"]
    reset_launches()
    with predict_calls() as calls:
        t0 = time.perf_counter()
        results = predict.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    launches = read_launches()
    # one bucket at batch 1: one eager call, one capture, then replays
    want_calls = {"predict.eager": 1, "predict.graph.capture": 1, "predict.graph.replay": BATCH - 2}
    check(calls == want_calls, f"predict: Predictor's calls {calls}, expected {want_calls}")
    expected = {name: 0 for name in launches}
    expected.update(roi_align_fwd=wrapper_calls(calls), nms_keep=2 * wrapper_calls(calls),
                    frozen_bn_act=trunk_bn_launches(load_cfg(CONFIG_BF16)) * wrapper_calls(calls))
    check(launches == expected, f"predict launches {launches}, expected {expected}")
    files = sorted(p.name for p in out.iterdir())
    check(files == sorted([f"img{i}.json" for i in range(BATCH)] + [f"img{i}_viz.jpg" for i in range(BATCH)]),
          f"predict wrote {files}")

    cfg = load_cfg(CONFIG_BF16)
    names, table = predict.serving_classes(cfg)
    post_cfg = PostprocessConfig.from_cfg(cfg, cfg.OPENDET_BENCHMARK, table)
    predictor = Predictor(cfg, post_cfg=post_cfg)
    load_weights_file(weights, predictor.model)
    transform = DetectionTransform(min_sizes=(cfg.INPUT.MIN_SIZE_TEST,), max_size=cfg.INPUT.MAX_SIZE_TEST,
                                   bucket_hw=tuple(cfg.TPU.TEST_BUCKET), max_gt=1, flip=False,
                                   fmt=cfg.INPUT.FORMAT, interp=cfg.TPU.RESIZE_INTERP)
    examples = [transform({"file_name": str(inputs / f"img{i}.jpg"), "image_id": i}, np.random.RandomState(0))
                for i in range(BATCH)]
    detections = 0
    for i, ex in enumerate(examples):
        dets = predictor(torch.from_numpy(ex.image[None]), torch.tensor([ex.image_hw], dtype=torch.float32))
        final = finalize_serve_image(*(getattr(dets, k)[0].cpu().numpy() for k in ("boxes", "scores", "classes",
                                                                                      "valid")),
                                     ex.image_hw, ex.original_hw, post_cfg)
        want = {"file_name": str(inputs / f"img{i}.jpg"), "boxes_xyxy": final.boxes.round(2).tolist(),
                "scores": final.scores.round(4).tolist(), "classes": final.classes.tolist(),
                "names": ["unknown" if int(c) == post_cfg.unknown_id else names[int(c)] for c in final.classes]}
        got = json.loads((out / f"img{i}.json").read_text())
        check(got == want, f"predict: img{i}.json differs from Predictor + finalize_serve_image")
        check(results[want["file_name"]] == want, f"predict: main's record of img{i} differs from its JSON")
        check(cv2.imread(str(out / f"img{i}_viz.jpg")).shape == (*EVAL_HW, 3), f"predict: img{i}_viz.jpg")
        detections += len(want["scores"])
    one = [(torch.from_numpy(ex.image[None]).to(dev), torch.tensor([ex.image_hw], dtype=torch.float32))
           for ex in examples]
    alone_ms = time_ms(torch, lambda: [predictor(im, hw) for im, hw in one], 3) / BATCH
    print(f"predict: the CLI wrote {BATCH} JSON files and overlays ({detections} detections), each equal to "
          f"Predictor + finalize_serve_image on the same pixels; CLI {BATCH / cli_s:.2f} img/s over {cli_s:.2f} s "
          f"(model build, weights, JPEG decode, resize, JSON and overlays included) beside Predictor alone "
          f"{1e3 / alone_ms:.2f} img/s at batch 1 ({alone_ms:.2f} ms an image); Predictor's calls "
          f"{json.dumps(calls)}, wrapper launches (eager and capturing calls) {json.dumps(launches)}",
          flush=True)
    del predictor
    torch.cuda.empty_cache()
    return launches, dict(cli_img_per_s=BATCH / cli_s, cli_s=cli_s, predictor_alone_img_per_s=1e3 / alone_ms,
                          detections=detections)


EXPORT_TOL = {"boxes": dict(rtol=1e-3, atol=1e-2), "scores": dict(rtol=1e-4, atol=2e-3)}  # tests/test_export_serving.py


def phase_export(torch, dev, work, weights):
    """``python -m openset_rcnn_tpu_torch.tools.export_serving`` in this
    process on the production config at batch 8 with the weights phase's
    ``.pth``, single program and ``--split``; both artifacts loaded back
    (``torch.export.load``) and run under ``entry_numerics`` on the serve
    batch: integer and boolean outputs exactly the live ``Predictor``'s,
    boxes and scores within the JAX round trip's tolerances; the loaded
    programs' runs count K1 1 and K4 2 launches a batch, and
    ``torch.profiler`` sees the kernels by name. Prints each artifact's
    size and ms per batch beside ``Predictor``'s."""
    from openset_rcnn_tpu_torch.device import entry_numerics
    from openset_rcnn_tpu_torch.engine.checkpoint import load_weights_file
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor
    from openset_rcnn_tpu_torch.tools import export_serving
    from torch.profiler import ProfilerActivity, profile

    out = str(work / "serving.pt2")
    argv = ["--config-file", str(CONFIG_BF16), "--batch", str(BATCH), "--out", out,
            "MODEL.WEIGHTS", weights, "MODEL.RPN.DELTA_BIAS_INIT", "1.0"]
    t0 = time.perf_counter()
    written = export_serving.main(argv)
    single_s = time.perf_counter() - t0
    written += export_serving.main(argv[:6] + ["--split"] + argv[6:])
    split_s = time.perf_counter() - t0 - single_s
    sizes = {Path(p).name: Path(p).stat().st_size / 1e6 for p in written}
    programs = {Path(p).name: export_serving.load(p) for p in written}
    cfg = load_cfg(CONFIG_BF16)
    predictor = Predictor(cfg)
    load_weights_file(weights, predictor.model)
    images, image_hw = serve_batch(torch, dev)
    images, image_hw = images.float(), image_hw.to(dev)
    live = predictor(images, image_hw)
    fwd, casc = programs["serving.pt2.fwd"], programs["serving.pt2.casc"]
    runs = {"export": lambda: programs["serving.pt2"](images, image_hw),
            "export_split": lambda: casc(*fwd(images, image_hw))}
    paths, result = {}, dict(sizes_mb=sizes, export_s=single_s, export_split_s=split_s)
    for label, run in runs.items():
        with torch.inference_mode(), entry_numerics():
            run()  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            got = run()
            torch.cuda.synchronize()
            launches = read_launches()
            expected = {name: 0 for name in launches}
            expected.update(roi_align_fwd=1, nms_keep=2, frozen_bn_act=trunk_bn_launches(cfg))
            check(launches == expected, f"{label}: the loaded program's launches {launches}, expected {expected}")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            kernels = {e.key for e in prof.key_averages()}
            seen = [k for k in ("roi_align_fwd_kernel", "nms_iou_mask_kernel", "nms_walk_kernel")
                    if any(k in key for key in kernels)]
            check(len(seen) == 3, f"{label}: the profiler saw {seen} of the port's kernels")
            ms = time_ms(torch, run, SERVE_BATCHES)
        diffs = {}
        for name, value in zip(live._fields, got):
            want = getattr(live, name)
            if name in EXPORT_TOL:
                torch.testing.assert_close(value, want, **EXPORT_TOL[name])
                diffs[name] = float((value - want).abs().max())
            else:
                check(torch.equal(value, want), f"{label}: {name} differs from the live Predictor")
        bitwise = all(torch.equal(v, getattr(live, n)) for n, v in zip(live._fields, got))
        paths[label] = launches
        result[label] = dict(ms_per_batch=ms, img_per_s=BATCH * 1e3 / ms, max_abs_diff=diffs, bitwise=bitwise)
        print(f"{label}: the loaded program against the live Predictor: integers and masks exact, largest "
              f"differences {json.dumps(diffs)}"
              f"{' (bitwise)' if bitwise else ''}; launches {json.dumps(launches)}; the profiler saw {seen}; "
              f"{ms:.2f} ms/batch ({BATCH * 1e3 / ms:.2f} img/s)", flush=True)
    with torch.inference_mode():
        result["predictor_ms_per_batch"] = time_ms(torch, lambda: predictor(images, image_hw), SERVE_BATCHES)
    print(f"export: written in {single_s:.1f} s (single) and {split_s:.1f} s (--split), sizes (MB) "
          f"{json.dumps({n: round(v, 1) for n, v in sizes.items()})}; Predictor on the same batch "
          f"{result['predictor_ms_per_batch']:.2f} ms/batch", flush=True)
    del programs, predictor
    torch.cuda.empty_cache()
    return paths, result


def phase_tools(torch, dev):
    """The weights, predict and export phases in one temporary directory
    (under TMPDIR, removed at the end, pass or fail): {path: launches},
    {path: results}."""
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    try:
        paths, results = {}, {}
        paths["weights"], results["weights"], weights = phase_weights(torch, dev, work)
        paths["predict"], results["predict"] = phase_predict(torch, dev, work, weights)
        export_paths, results["export"] = phase_export(torch, dev, work, weights)
        paths.update(export_paths)
        return paths, results
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# Multi-process phases: ranks started from this script (parallel.launch, or
# torch.multiprocessing for the group of one), each on cuda:0.
# ---------------------------------------------------------------------------


def rank_device(torch):
    return torch.device("cuda", torch.cuda.current_device())


def run_ranks(fn, n, *args):
    """``fn(*args)`` in ``n`` gloo processes sharing the card; rank 0's return."""
    from openset_rcnn_tpu_torch.parallel import launch
    from openset_rcnn_tpu_torch.parallel.multihost import free_port

    return launch(fn, n, dist_url=f"tcp://127.0.0.1:{free_port()}", args=args, backend="gloo", device_type="cuda")


def record_first_draws(path):
    """Save this process's first step's sampling draws to ``path``."""
    import torch
    from openset_rcnn_tpu_torch.engine import train_state

    losses = train_state.training_losses_and_stats

    def recording(*args, uniforms=None, **kwargs):
        if not Path(path).exists():
            torch.save({k: v.cpu() for k, v in uniforms.items()}, path)
        return losses(*args, uniforms=uniforms, **kwargs)

    train_state.training_losses_and_stats = recording
    return losses


def load_state(torch, weights):
    """The model state dict of a checkpoint file, or None (a seeded init)."""
    return torch.load(weights, map_location="cpu", weights_only=True)["model"] if weights else None


def gradient_capture(model, layout, grads):
    """A ``mark`` for Trainer.step that fills ``grads`` with the gradients
    as the optimizer receives them (after DDP's reduction, before clipping),
    the box head's shards gathered over the model group (every rank calls
    it), f32 on the host."""
    from openset_rcnn_tpu_torch.parallel.mesh import MODEL_SHARDED, gather

    def mark(stage):
        if stage == "backward":
            for name, p in model.named_parameters():
                if p.grad is not None:
                    dim = MODEL_SHARDED.get(name) if layout.model > 1 else None
                    grads[name] = (p.grad if dim is None else gather(p.grad, dim, layout)).float().cpu()

    return mark


def train_steps(torch, trainer, batch, steps, first_mark=None):
    """``steps`` Trainer steps on one batch: the first step's metrics on the
    host and each step's ms (CUDA events); ``first_mark``: the first step's
    ``mark``."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    events[0].record()
    first = None
    for i in range(steps):
        metrics = trainer.step(batch, mark=first_mark if i == 0 else None)
        events[i + 1].record()
        if first is None:
            first = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    return first, [events[i].elapsed_time(events[i + 1]) for i in range(steps)]


def train_rank(config, tpu, mesh, steps, weights, work):
    """A rank of ddp_gloo2 / tp_gloo: Trainer under the (data, model) layout
    on its images' rows of the phase's global batch, ``steps`` steps with
    the launches counted, then the gathered checkpoint (rank 0 writes) and
    step 1's gradients (rank 0 saves them)."""
    import torch
    from openset_rcnn_tpu_torch.engine.checkpoint import Checkpointer
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.parallel import process_index
    from openset_rcnn_tpu_torch.parallel.mesh import make_layout
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    dev = rank_device(torch)
    cfg = load_cfg(config, **tpu)
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL = mesh
    layout = make_layout(*mesh)
    host = bench_batch(torch, cfg.SOLVER.IMS_PER_BATCH, cfg.TPU.MAX_GT_PER_IMAGE)
    b = cfg.SOLVER.IMS_PER_BATCH // layout.data
    rows = slice(layout.data_index * b, (layout.data_index + 1) * b)
    batch = ImageBatch(host.images[rows].to(dev), host.image_hw[rows].to(dev),
                       GroundTruth(host.gt.boxes[rows].to(dev), host.gt.classes[rows].to(dev),
                                   host.gt.valid[rows].to(dev)))
    record_first_draws(str(Path(work) / f"draws_rank{process_index()}.pt"))
    trainer = Trainer(cfg, seed=0, layout=layout, state_dict=load_state(torch, weights))
    grads = {}
    reset_launches()
    first, step_ms = train_steps(torch, trainer, batch, steps, gradient_capture(trainer.model, layout, grads))
    launches = read_launches()
    Checkpointer(work, layout).save(trainer.state, steps)
    if process_index() == 0:
        torch.save(grads, Path(work) / "grads.pt")
    return dict(first=first, step_ms=step_ms, launches=launches, rows=(rows.start, rows.stop),
                layout=(layout.data, layout.model), backend=torch.distributed.get_backend())


def one_process_reference(torch, dev, config, tpu, steps, weights, work):
    """The same steps by one process on the whole global batch: the first
    step's draws, metrics and gradients, step ms, and its checkpoint under
    ``work``."""
    from openset_rcnn_tpu_torch.engine import train_state
    from openset_rcnn_tpu_torch.engine.checkpoint import Checkpointer
    from openset_rcnn_tpu_torch.parallel.mesh import SINGLE
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    cfg = load_cfg(config, **tpu)
    host = bench_batch(torch, cfg.SOLVER.IMS_PER_BATCH, cfg.TPU.MAX_GT_PER_IMAGE)
    batch = ImageBatch(host.images.to(dev), host.image_hw.to(dev),
                       GroundTruth(host.gt.boxes.to(dev), host.gt.classes.to(dev), host.gt.valid.to(dev)))
    draws = Path(work) / "draws_one.pt"
    losses = record_first_draws(str(draws))
    try:
        trainer = train_state.Trainer(cfg, dev, seed=0, state_dict=load_state(torch, weights))
        grads = {}
        first, step_ms = train_steps(torch, trainer, batch, steps, gradient_capture(trainer.model, SINGLE, grads))
    finally:
        train_state.training_losses_and_stats = losses
    Checkpointer(work).save(trainer.state, steps)
    del trainer
    torch.cuda.empty_cache()
    return dict(first=first, step_ms=step_ms, draws=torch.load(draws), grads=grads)


def gradient_deviations(got, want):
    """{name: max |got - want| / max |want|} over the trainable tensors."""
    check(got.keys() == want.keys(), "the gradients' tensors differ")
    return {n: float((got[n] - w).abs().max() / w.abs().max().clamp(min=1e-30)) for n, w in want.items()}


def metric_deviations(got, ref):
    """{metric: |got - ref| / |ref|} over step 1's metrics, counts included."""
    return {k: abs(got[k] - v) / max(abs(v), 1e-30) for k, v in ref.items()}


def compare_runs(torch, label, got, want, got_dir, want_dir, steps, ref=None):
    """The multi-process run against one process at the global batch
    (``want``): each rank's draws its rows exactly, the checkpoints' keys and
    shapes equal and their values within DDP_PARAM_TOL. Step 1 against
    ``ref``, the reference that does the ranks' work (one process itself
    unless given, ``split_step_reference``): counts exactly, the other
    metrics within DDP_METRIC_RTOL, every gradient tensor within DDP_GRAD_TOL
    of its largest. With ``ref`` given (bf16), step 1 is also held against
    one process at the global batch: counts within DDP_BF16_COUNT_RTOL, the
    other metrics within DDP_BF16_METRIC_RTOL, and the gradients' distance
    printed. Returns the measured deviations."""
    import numpy as np

    ranks = sorted(Path(got_dir).glob("draws_rank*.pt"))
    n_data, n_model = got["layout"]
    check(len(ranks) == n_data * n_model, f"{label}: draws of {len(ranks)} ranks")
    b = len(want["draws"]["rpn"]) // n_data
    for path in ranks:
        r = int(path.stem[len("draws_rank"):])
        rows = slice((r // n_model) * b, (r // n_model + 1) * b)
        draws = torch.load(path)
        check(draws.keys() == want["draws"].keys() and all(torch.equal(v, want["draws"][k][rows])
                                                           for k, v in draws.items()),
              f"{label}: rank {r}'s sampling draws are not the one-process draws' rows {rows}")
    grads = torch.load(Path(got_dir) / "grads.pt")
    out = {}
    if ref is not None:
        near = metric_deviations(got["first"], want["first"])
        near_counts = max(near[k] for k in COUNT_STATS)
        near_metrics = max((v, k) for k, v in near.items() if k not in COUNT_STATS)
        near_grads = gradient_deviations(grads, want["grads"])
        near_grad = max((v, k) for k, v in near_grads.items())
        print(f"{label}: step 1 against one process at the global batch: counts "
              + json.dumps({k: (got["first"][k], want["first"][k]) for k in COUNT_STATS})
              + f", largest count deviation {near_counts:.3e} (limit {DDP_BF16_COUNT_RTOL}), largest other metric "
              f"deviation {near_metrics[0]:.3e} ({near_metrics[1]}; limit {DDP_BF16_METRIC_RTOL}); gradients at most "
              f"{near_grad[0]:.3e} of a tensor's largest ({near_grad[1]}; median "
              f"{float(np.median(list(near_grads.values()))):.3e}); relative metric deviations "
              + json.dumps({k: float(f"{v:.3e}") for k, v in near.items()}), flush=True)
        check(near_counts <= DDP_BF16_COUNT_RTOL, f"{label}: step-1 counts {near_counts:.3e} from one process")
        check(near_metrics[0] <= DDP_BF16_METRIC_RTOL,
              f"{label}: step-1 metric {near_metrics[1]} {near_metrics[0]:.3e} from one process")
        out.update(one_process_count_rel_dev=near_counts, one_process_metric_rel_dev=near_metrics[0],
                   one_process_grad_rel_dev=near_grad[0])
    ref = ref or want
    metric_dev = {k: v for k, v in metric_deviations(got["first"], ref["first"]).items() if k not in COUNT_STATS}
    counts = {k: (got["first"][k], ref["first"][k]) for k in COUNT_STATS}
    grad_dev = gradient_deviations(grads, ref["grads"])
    worst_grad = max((v, k) for k, v in grad_dev.items())
    a = torch.load(Path(got_dir) / f"model_{steps:07d}.pt", map_location="cpu", weights_only=True)
    w = torch.load(Path(want_dir) / f"model_{steps:07d}.pt", map_location="cpu", weights_only=True)
    same_form = ({k: tuple(v.shape) for k, v in a["model"].items()} == {k: tuple(v.shape) for k, v in w["model"].items()}
                 and {k: tuple(v["momentum_buffer"].shape) for k, v in a["optimizer"]["state"].items()}
                 == {k: tuple(v["momentum_buffer"].shape) for k, v in w["optimizer"]["state"].items()})
    worst, worst_name, outside = 0.0, "", []
    for k, v in w["model"].items():
        x, y = a["model"][k].double().numpy(), v.double().numpy()
        excess = np.abs(x - y) - (DDP_PARAM_TOL["atol"] + DDP_PARAM_TOL["rtol"] * np.abs(y))
        if excess.max(initial=-1.0) > 0:
            outside.append(k)
        dev = float(np.abs(x - y).max(initial=0.0))
        if dev > worst:
            worst, worst_name = dev, k
    bitwise = all(torch.equal(a["model"][k], v) for k, v in w["model"].items())
    worst_metric = max(metric_dev.items(), key=lambda kv: kv[1])
    print(f"{label}: step-1 metrics' relative deviations from the reference " + json.dumps({k: float(f"{v:.3e}") for k, v in
                                                                        metric_dev.items()}), flush=True)
    print(f"{label}: layout {n_data} x {n_model} ({got['backend']}), draws of {len(ranks)} ranks exactly the "
          f"one-process rows; step 1 against the reference: counts {json.dumps(counts)}, largest relative metric "
          f"deviation {worst_metric[1]:.3e} ({worst_metric[0]}), gradients at most {worst_grad[0]:.3e} of a "
          f"tensor's largest ({worst_grad[1]}; {len(grad_dev)} tensors); after {steps} steps the parameters are "
          f"{'bitwise equal' if bitwise else f'at most {worst:.3e} apart ({worst_name})'}, "
          f"{len(outside)} tensors outside rtol {DDP_PARAM_TOL['rtol']} / atol {DDP_PARAM_TOL['atol']}; "
          f"the checkpoint's keys and shapes {'equal' if same_form else 'DIFFER'}", flush=True)
    check(all(g == w_ for g, w_ in counts.values()), f"{label}: step-1 counts {counts}")
    check(worst_metric[1] <= DDP_METRIC_RTOL, f"{label}: step-1 metric {worst_metric[0]} off by {worst_metric[1]:.3e}")
    check(worst_grad[0] <= DDP_GRAD_TOL, f"{label}: step-1 gradient {worst_grad[1]} off by {worst_grad[0]:.3e}")
    check(same_form, f"{label}: the gathered checkpoint's keys or shapes differ from one process's")
    check(not outside, f"{label}: parameters outside the tolerance: {outside[:5]}")
    out.update(metric_rel_dev=worst_metric[1], grad_rel_dev=worst_grad[0], param_max_abs_dev=worst, bitwise=bitwise)
    return out


class ShareSum:
    """The ``global_sum`` hook of one share of a batch split into ``size``
    shares in one process: on a first pass it records its share's values;
    given the other shares' records, it returns their sum with its own (the
    loss hooks sum integer counts only, so the sums are exact)."""

    def __init__(self, size, others=()):
        self.size, self.others, self.seen = size, list(others), []

    def __call__(self, x):
        self.seen.append(x.detach().clone())
        return x + sum(o[len(self.seen) - 1] for o in self.others) if self.others else x


def split_step_reference(torch, dev, config, weights, parts):
    """Step 1 of one process computing the phase's global batch as
    ``parts`` shares of B / ``parts`` images, each share's forward and
    backward at that batch size, with every global sum taken over the shares
    and the one-process step's draws: what ``parts`` data-parallel ranks
    compute, without processes or DDP. {"first": metrics, "grads": the
    shares' gradients summed (DDP's mean of W x each rank's), f32 on the
    host}."""
    from openset_rcnn_tpu_torch.device import entry_numerics
    from openset_rcnn_tpu_torch.engine.train_state import Trainer, step_generator
    from openset_rcnn_tpu_torch.models.detector import training_losses_and_stats
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    cfg = load_cfg(config)
    trainer = Trainer(cfg, dev, seed=0, state_dict=load_state(torch, weights))
    host = bench_batch(torch, cfg.SOLVER.IMS_PER_BATCH, cfg.TPU.MAX_GT_PER_IMAGE)
    gt = host.gt
    batch = ImageBatch(host.images.to(dev), host.image_hw.to(dev),
                       GroundTruth(gt.boxes.to(dev), gt.classes.to(dev), gt.valid.to(dev)))
    anchors, level_sizes = trainer.anchors(BUCKET)
    draws = trainer.sampling_draws(batch, anchors.shape[0], level_sizes, step_generator(0, 0, dev))
    b = len(batch.images) // parts

    def share(i, hook, backward):
        rows = slice(i * b, (i + 1) * b)
        part = ImageBatch(batch.images[rows], batch.image_hw[rows],
                          GroundTruth(batch.gt.boxes[rows], batch.gt.classes[rows], batch.gt.valid[rows]))
        with torch.set_grad_enabled(backward), entry_numerics(deterministic=True):
            losses, stats = training_losses_and_stats(trainer.model, part, trainer.spec, anchors, level_sizes,
                                                      uniforms={k: v[rows] for k, v in draws.items()},
                                                      global_sum=hook)
            if backward:
                sum(losses.values()).backward()
        return {k: float(v) for k, v in losses.items()}, {k: float(v) for k, v in stats.items()}

    recorded = [ShareSum(parts) for _ in range(parts)]
    for i in range(parts):
        share(i, recorded[i], False)
    trainer.model.zero_grad(set_to_none=True)
    out = [share(i, ShareSum(parts, [r.seen for j, r in enumerate(recorded) if j != i]), True) for i in range(parts)]
    grads = {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters() if p.grad is not None}
    losses = {k: sum(o[0][k] for o in out) for k in out[0][0]}
    metrics = {**losses, **out[0][1]}
    metrics["total_loss"] = sum(losses.values())
    metrics["lr"] = float(trainer.schedule(0))
    del trainer
    torch.cuda.empty_cache()
    return dict(first=metrics, grads=grads)


def batch_split_drift(torch, dev, config, weights, parts):
    """How far one process's forward of the phase's images at batch B /
    ``parts`` lies from the same images inside the whole batch B (the
    one-process step's), under the train step's numerics: per FPN level,
    max |difference| / max |value|. Zero where cuDNN computes each image
    alike at both batch sizes."""
    from openset_rcnn_tpu_torch.device import entry_numerics
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, build_model

    cfg = load_cfg(config)
    host = bench_batch(torch, cfg.SOLVER.IMS_PER_BATCH, cfg.TPU.MAX_GT_PER_IMAGE)
    model = build_model(ModelSpec.from_cfg(cfg), dev, load_state(torch, weights), seed=0)
    images, hw = host.images.to(dev), host.image_hw.to(dev)
    b = len(images) // parts
    with torch.no_grad(), entry_numerics(deterministic=True):
        whole = model.features(images, hw)
        split = [model.features(images[i * b:(i + 1) * b], hw[i * b:(i + 1) * b]) for i in range(parts)]
    drift = {k: float((torch.cat([p[k] for p in split]) - v).abs().max() / v.abs().max()) for k, v in whole.items()}
    del model, whole, split
    torch.cuda.empty_cache()
    return drift


def calibrated_weights(torch, dev, cfg, work):
    """A seeded init of ``cfg`` with FrozenBN calibrated on the phase's
    global batch (see calibrate_frozen_bn), saved under ``work``."""
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, build_model

    host = bench_batch(torch, cfg.SOLVER.IMS_PER_BATCH, cfg.TPU.MAX_GT_PER_IMAGE)
    model = build_model(ModelSpec.from_cfg(cfg), dev, seed=0)
    calibrate_frozen_bn(torch, model, host.images.to(dev), host.image_hw.to(dev))
    path = Path(work) / "init.pt"
    torch.save({"model": model.state_dict()}, path)
    del model
    torch.cuda.empty_cache()
    return str(path)


def timed_cli_run(torch, argv):
    """The training CLI's ``main`` on ``argv`` with every Trainer.step timed
    by CUDA events and the launches counted: {step, launches, groups (the
    process group's backend and size at each step, or None), step_ms}."""
    from openset_rcnn_tpu_torch import train as cli
    from openset_rcnn_tpu_torch.engine import train_state

    step, times, groups = train_state.Trainer.step, [], []

    def timed(self, batch, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(self, batch, *args, **kwargs)
        end.record()
        times.append((start, end))
        dist = torch.distributed
        groups.append((dist.get_backend(), dist.get_world_size()) if dist.is_initialized() else None)
        return metrics

    train_state.Trainer.step = timed
    try:
        reset_launches()
        final = cli.main(cli.get_parser().parse_args(argv))
        torch.cuda.synchronize()
    finally:
        train_state.Trainer.step = step
    return dict(step=final if isinstance(final, int) else final.step, launches=read_launches(), groups=groups,
                step_ms=[s.elapsed_time(e) for s, e in times])


def step_ms_on_one_batch(torch, weights, layout):
    """Trainer.step of the production config on bench.py's batch of 16,
    outside any loader: DDP_TIMED steps after 2 warm-up steps, ms each
    (CUDA events). ``layout``: a ``Layout`` (under it, DDP)."""
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    cfg = load_cfg(CONFIG_BF16)
    dev = rank_device(torch)
    host = bench_batch(torch, cfg.SOLVER.IMS_PER_BATCH, cfg.TPU.MAX_GT_PER_IMAGE)
    batch = ImageBatch(host.images.to(dev), host.image_hw.to(dev),
                       GroundTruth(host.gt.boxes.to(dev), host.gt.classes.to(dev), host.gt.valid.to(dev)))
    trainer = Trainer(cfg, seed=0, layout=layout, state_dict=load_state(torch, weights))
    for _ in range(2):
        trainer.step(batch)
    _, step_ms = train_steps(torch, trainer, batch, DDP_TIMED)
    del trainer
    torch.cuda.empty_cache()
    return step_ms


def ddp_nccl_child(local_rank, argv, records, out, weights):
    """ddp_nccl's process: the CLI as a user launches it on one GPU with a
    rendezvous URL (``main`` forms an NCCL group of one); then Trainer.step
    under DDP in a new NCCL group of one, on one batch; written to ``out``."""
    import torch
    from openset_rcnn_tpu_torch.parallel import initialize_distributed
    from openset_rcnn_tpu_torch.parallel.mesh import make_layout
    from openset_rcnn_tpu_torch.parallel.multihost import free_port

    register_records(DDP_DATASET, records)
    result = timed_cli_run(torch, argv)
    initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, 0, "nccl", "cuda")
    try:
        result["step_ms_one_batch"] = step_ms_on_one_batch(torch, weights, make_layout(1, 1))
        result["group"] = (torch.distributed.get_backend(), torch.distributed.get_world_size())
    finally:
        torch.distributed.destroy_process_group()
    Path(out).write_text(json.dumps(result))


def phase_ddp_nccl(torch, dev, work):
    """ddp_nccl: ``python -m openset_rcnn_tpu_torch.train --num-gpus 1
    --dist-url tcp://127.0.0.1:<port>`` (its ``main``, in a process started
    here) forms an NCCL group of one and trains the production config under
    DDP at batch 16, 832x1344, DDP_STEPS steps, on synthetic PNGs from a
    calibrated init; then the same command without ``--dist-url`` (no group,
    no DDP) in this process. Gate: the two final checkpoints bitwise equal.
    ms/step of each run's steps inside do_train's loop (shared with the
    loader's threads), and of DDP_TIMED steps on one batch outside any
    loader, under DDP in an NCCL group of one and without a group."""
    import torch.multiprocessing as mp
    from openset_rcnn_tpu_torch.data import TrainLoader, generate_synthetic_dataset
    from openset_rcnn_tpu_torch.engine.train_loop import build_train_transform
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, build_model
    from openset_rcnn_tpu_torch.parallel.mesh import SINGLE
    from openset_rcnn_tpu_torch.parallel.multihost import free_port

    t0 = time.perf_counter()
    cfg = load_cfg(CONFIG_BF16)
    records = generate_synthetic_dataset(str(work / "ddp"), DDP_RECORDS, EVAL_HW, num_classes=80, max_objects=6,
                                         seed=31)
    first, _ = next(iter(TrainLoader(records, build_train_transform(cfg), cfg.SOLVER.IMS_PER_BATCH, seed=0)))
    model = build_model(ModelSpec.from_cfg(cfg), dev, seed=0)
    calibrate_frozen_bn(torch, model, first.images.to(dev), first.image_hw.to(dev))
    weights = work / "ddp_init.pt"
    torch.save({"model": model.state_dict()}, weights)
    del model
    torch.cuda.empty_cache()

    def argv(out):
        return ["--config-file", str(CONFIG_BF16), "SEED", "0", "OUTPUT_DIR", str(out), "MODEL.WEIGHTS",
                str(weights), "MODEL.RPN.DELTA_BIAS_INIT", "1.0", "DATASETS.TRAIN", f"('{DDP_DATASET}',)",
                "SOLVER.MAX_ITER", str(DDP_STEPS), "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0"]

    flags = ["--num-gpus", "1", "--dist-url", f"tcp://127.0.0.1:{free_port()}"]
    result = work / "ddp_nccl.json"
    wall = time.perf_counter()
    mp.start_processes(ddp_nccl_child, args=(flags + argv(work / "ddp_run"), records, str(result), str(weights)),
                       nprocs=1, join=True, start_method="spawn")
    wall = time.perf_counter() - wall
    ddp = json.loads(result.read_text())
    check(ddp["step"] == DDP_STEPS and ddp["groups"] == [["nccl", 1]] * DDP_STEPS and ddp["group"] == ["nccl", 1],
          f"ddp_nccl: ended at {ddp['step']}, groups {ddp['groups']}, {ddp['group']}")
    register_records(DDP_DATASET, records)
    alone = timed_cli_run(torch, argv(work / "alone_run"))
    check(alone["step"] == DDP_STEPS and alone["groups"] == [None] * DDP_STEPS, f"ddp_nccl: the run without a group")
    torch.cuda.empty_cache()
    alone_one_batch = step_ms_on_one_batch(torch, str(weights), SINGLE)
    got, want = (torch.load(work / run / f"model_{DDP_STEPS:07d}.pt", map_location="cpu", weights_only=True)["model"]
                 for run in ("ddp_run", "alone_run"))
    differ = [k for k, v in want.items() if not torch.equal(v, got[k])]
    # the first step of each builds cuDNN plans (and DDP's buckets)
    ddp_mean = sum(ddp["step_ms"][1:]) / (DDP_STEPS - 1)
    alone_mean = sum(alone["step_ms"][1:]) / (DDP_STEPS - 1)
    ddp_batch, alone_batch = ddp["step_ms_one_batch"], alone_one_batch
    ddp_batch_mean, alone_batch_mean = sum(ddp_batch) / DDP_TIMED, sum(alone_batch) / DDP_TIMED
    print(f"ddp_nccl: the CLI with --num-gpus 1 --dist-url, an NCCL group of one, {DDP_STEPS} steps of "
          f"{CONFIG_BF16.name} at batch {cfg.SOLVER.IMS_PER_BATCH} in {wall:.1f} s with the process start; "
          f"parameters {'bitwise equal to' if not differ else f'DIFFER in {len(differ)} tensors from'} "
          f"the same command without a group; Trainer.step inside do_train, ms: under DDP "
          f"{[round(x, 2) for x in ddp['step_ms']]} (steady {ddp_mean:.2f}), without a group "
          f"{[round(x, 2) for x in alone['step_ms']]} (steady {alone_mean:.2f}); on one batch, no loader, after 2 "
          f"warm-up steps: under DDP {[round(x, 2) for x in ddp_batch]} (mean {ddp_batch_mean:.2f}), without a group "
          f"{[round(x, 2) for x in alone_batch]} (mean {alone_batch_mean:.2f}); launches (DDP run) "
          + json.dumps(ddp["launches"]) + f"; the phase took {time.perf_counter() - t0:.1f} s", flush=True)
    check(not differ, f"ddp_nccl: parameters differ from the run without a group: {differ[:5]}")
    check(ddp["launches"] == alone["launches"], f"ddp_nccl: launches {ddp['launches']} against {alone['launches']}")
    return ddp["launches"], dict(ms_per_step=ddp_batch_mean, ms_per_step_without_group=alone_batch_mean,
                                 step_ms=ddp_batch, step_ms_without_group=alone_batch,
                                 loop_step_ms=ddp["step_ms"], loop_step_ms_without_group=alone["step_ms"],
                                 seconds_with_process_start=wall)


def phase_ddp_gloo2(torch, dev, work):
    """ddp_gloo2: two gloo ranks share cuda:0 (NCCL refuses two ranks on one
    card) and train the production config at global batch 16 (8 a rank) for
    DDP_STEPS steps against one process on the same batch: draws, step-1
    metrics, parameters (compare_runs)."""
    cfg = load_cfg(CONFIG_BF16)
    weights = calibrated_weights(torch, dev, cfg, work)
    want_dir, got_dir = work / "gloo_one", work / "gloo2"
    want_dir.mkdir()
    got_dir.mkdir()
    want = one_process_reference(torch, dev, CONFIG_BF16, {}, DDP_STEPS, weights, want_dir)
    wall = time.perf_counter()
    got = run_ranks(train_rank, 2, CONFIG_BF16, {}, (2, 1), DDP_STEPS, weights, str(got_dir))
    wall = time.perf_counter() - wall
    drift = batch_split_drift(torch, dev, CONFIG_BF16, weights, 2)
    print("ddp_gloo2: the forward of half the batch at batch 8 against the same images at batch 16, max |diff| / "
          "max |value| per level " + json.dumps({k: float(f"{v:.3e}") for k, v in drift.items()}), flush=True)
    # bf16: cuDNN rounds a batch of 8 otherwise than the same images inside 16
    # (the drift above), so step 1 is held exactly against one process
    # computing the two ranks' shares at batch 8 each, and within the drift's
    # limits against one process at batch 16, as the parameters are
    shares = split_step_reference(torch, dev, CONFIG_BF16, weights, 2)
    dev_ = compare_runs(torch, "ddp_gloo2", got, want, got_dir, want_dir, DDP_STEPS, ref=shares)
    print(f"ddp_gloo2: ms/step (rank 0) {[round(x, 2) for x in got['step_ms']]}, one process "
          f"{[round(x, 2) for x in want['step_ms']]}; {wall:.1f} s with the processes' start; launches (rank 0) "
          + json.dumps(got["launches"]), flush=True)
    return got["launches"], dict(step_ms=got["step_ms"], one_process_step_ms=want["step_ms"], **dev_)


def phase_tp_gloo(torch, dev, work):
    """tp_gloo: the f32 config with TPU.MESH_MODEL 2 (box_head fc1/fc2
    tensor-parallel) on 2 gloo ranks, and 2 x 2 on 4, at global batch
    TRAIN_BATCH for TP_STEPS steps against one process (compare_runs, the
    gathered checkpoint's keys and shapes included)."""
    want_dir = work / "tp_one"
    want_dir.mkdir()
    want = one_process_reference(torch, dev, CONFIG, {}, TP_STEPS, None, want_dir)
    drift = batch_split_drift(torch, dev, CONFIG, None, 2)
    print("tp_gloo: the f32 forward of half the batch at batch 2 against the same images at batch 4, max |diff| / "
          "max |value| per level " + json.dumps({k: float(f"{v:.3e}") for k, v in drift.items()}), flush=True)
    paths, results = {}, {}
    for label, mesh in (("tp_gloo", (1, 2)), ("tp_gloo_2x2", (2, 2))):
        got_dir = work / label
        got_dir.mkdir()
        wall = time.perf_counter()
        got = run_ranks(train_rank, mesh[0] * mesh[1], CONFIG, {}, mesh, TP_STEPS, None, str(got_dir))
        wall = time.perf_counter() - wall
        results[label] = dict(step_ms=got["step_ms"], **compare_runs(torch, label, got, want, got_dir, want_dir,
                                                                      TP_STEPS))
        print(f"{label}: ms/step (rank 0) {[round(x, 2) for x in got['step_ms']]}, one process "
              f"{[round(x, 2) for x in want['step_ms']]}; {wall:.1f} s with the processes' start; launches (rank 0) "
              + json.dumps(got["launches"]), flush=True)
        paths[label] = got["launches"]
    return paths, results


def eval_rank(config, out, shard=None):
    """A rank of eval_gloo2 (or one process): do_test over the eval phase's
    records (``shard`` (i, n): over records[i::n] only, as rank i of n
    infers them); its metrics, launches, and every image's detections as
    the evaluator received them, gathered from all ranks."""
    import numpy as np
    import torch
    from openset_rcnn_tpu_torch.engine.train_loop import do_test
    from openset_rcnn_tpu_torch.evaluation.voc_eval import OpensetVocEvaluator
    from openset_rcnn_tpu_torch.parallel import gather_object

    cfg = load_cfg(config)
    cfg.OUTPUT_DIR = out
    records, pixels = eval_records(np, EVAL_HW)
    register_eval(EVAL_DATASET, records if shard is None else records[shard[0]::shard[1]])
    transform = in_memory_transform(cfg, pixels)
    seen, process = {}, OpensetVocEvaluator.process

    def spy(self, image_id, boxes, scores, classes):
        seen[image_id] = tuple(np.array(a) for a in (boxes, scores, classes))
        return process(self, image_id, boxes, scores, classes)

    OpensetVocEvaluator.process = spy
    try:
        reset_launches()
        results = do_test(cfg, datasets=[EVAL_DATASET], transform=transform)[EVAL_DATASET]
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        OpensetVocEvaluator.process = process
    detections = {k: v for part in gather_object(seen) for k, v in part.items()}
    return dict(results=results, launches=launches, detections=detections)


def differing_images(np, got, want):
    """Image ids whose detections are not exactly ``want``'s (or missing)."""
    return sorted(k for k in set(want) | set(got) if k not in got or k not in want
                  or not all(np.array_equal(x, y) for x, y in zip(got[k], want[k])))


def phase_eval_gloo2(torch, dev, work):
    """eval_gloo2: do_test on two gloo ranks (records i::2 on rank i; the
    evaluator gathers the detections) against one process, on the f32
    config and on the production config. Gates: in f32 every image's
    detections exactly one process's; in bf16 cuDNN rounds an
    image by its place in the batch, so the two ranks' detections are held
    exactly against one process inferring each rank's records alone (the
    same batches), and their distance from one process over all records is
    printed. The metrics are printed, not gated: the seeded random weights
    score 0 on every one (tests/test_torch_port_ddp.py holds the evaluator's
    merge across processes on metrics that are not 0)."""
    import numpy as np

    paths, results = {}, {}
    for label, config in (("f32", CONFIG), ("bf16", CONFIG_BF16)):
        one = eval_rank(config, str(work / f"eval_one_{label}"))
        wall = time.perf_counter()
        got = run_ranks(eval_rank, 2, config, str(work / f"eval_two_{label}"))
        wall = time.perf_counter() - wall
        dets, want = got["detections"], one["detections"]
        off_one = differing_images(np, dets, want)
        shards = {}
        if label == "bf16":
            for i in range(2):
                shards.update(eval_rank(config, str(work / f"eval_shard{i}"), (i, 2))["detections"])
        off_shards = differing_images(np, dets, shards) if shards else []
        n_dets = sum(len(d[1]) for d in dets.values())
        print(f"eval_gloo2 ({label}): do_test on 2 processes ({wall:.1f} s with their start): {len(dets)} images' "
              f"detections ({n_dets} boxes); {len(off_one)} images differ from one process over all records"
              + (f" ({off_one[:6]})" if off_one else "")
              + (f"; {len(off_shards)} differ from one process inferring each rank's records alone" if shards else "")
              + "; metrics (not gated) " + json.dumps(got["results"]) + ", one process's " + json.dumps(one["results"])
              + "; launches (rank 0) " + json.dumps(got["launches"]), flush=True)
        check(len(dets) == EVAL_LANDSCAPE + EVAL_PORTRAIT, f"eval_gloo2 ({label}): {len(dets)} images")
        check(not (off_shards if shards else off_one), f"eval_gloo2 ({label}): detections differ")
        paths[label] = got["launches"]
        results[label] = dict(results=got["results"], boxes=n_dets, images_off_one_process=len(off_one),
                              seconds_with_process_start=wall)
    return paths["bf16"], results


def phase_multiprocess(torch, dev):
    """The multi-process phases in one temporary directory (under TMPDIR,
    removed at the end, pass or fail): {path: launches}, {path: results}.
    Each checks that its kernels launched on its rank 0."""
    import shutil
    import tempfile

    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ddp_"))
    try:
        paths, results = {}, {}
        paths["ddp_nccl"], results["ddp_nccl"] = phase_ddp_nccl(torch, dev, work)
        paths["ddp_gloo2"], results["ddp_gloo2"] = phase_ddp_gloo2(torch, dev, work)
        tp_paths, tp_results = phase_tp_gloo(torch, dev, work)
        paths.update(tp_paths)
        results.update(tp_results)
        paths["eval_gloo2"], results["eval_gloo2"] = phase_eval_gloo2(torch, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bf16_fwd, bf16_bwd = train_kernels(load_cfg(CONFIG_BF16))
    f32_fwd, f32_bwd = train_kernels(load_cfg())
    want = {"ddp_nccl": (bf16_fwd, bf16_bwd, "iou_match"), "ddp_gloo2": (bf16_fwd, bf16_bwd, "iou_match"),
            "tp_gloo": (f32_fwd, f32_bwd, "iou_match"), "tp_gloo_2x2": (f32_fwd, f32_bwd, "iou_match"),
            "eval_gloo2": ("roi_align_fwd", "nms_keep")}
    for path, names in want.items():
        for name in names:
            check(paths[path][name] > 0, f"{path}: {name} was not launched ({paths[path]})")
    return paths, results


def step_timings(torch, dev):
    """``--step-timings``: ms/step of train (f32, batch 4) and train_bf16
    (batch 16), one profiled f32 step, and whether two steps repeat bitwise."""
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    out = {}
    for label, cfg, batch_size, calibrate in (("train", load_cfg(), TRAIN_BATCH, False),
                                              ("train_bf16", load_cfg(CONFIG_BF16), TRAIN_BATCH_BF16, True)):
        trainer = Trainer(cfg, seed=0)
        host = bench_batch(torch, batch_size, cfg.TPU.MAX_GT_PER_IMAGE)
        batch = ImageBatch(host.images.to(dev), host.image_hw.to(dev),
                           GroundTruth(host.gt.boxes.to(dev), host.gt.classes.to(dev), host.gt.valid.to(dev)))
        if calibrate:
            calibrate_frozen_bn(torch, trainer.model, batch.images, batch.image_hw)
        for _ in range(TRAIN_WARMUP):
            trainer.step(batch)
        ms = time_ms(torch, lambda: trainer.step(batch), TRAIN_STEPS)
        profile = profile_step(torch, lambda: trainer.step(batch))
        n_params, differ, _ = repeat_step(torch, trainer, batch)
        out[label] = dict(ms_per_step=ms, batch=batch_size, repeat_bitwise=not differ,
                          tensors_differing=len(differ), device_idle_share=profile["idle_share"],
                          top_kernels_ms=profile["top_kernels_ms"])
        del trainer, batch
        torch.cuda.empty_cache()
    return out


def ptxas_kernel(line):
    """The kernel named in a line of ptxas's report (its mangled name carries
    each identifier behind its length)."""
    found = re.findall(r"\w*_kernel", line)
    return re.split(r"\d+(?=[A-Za-z])", found[-1])[-1] if found else ""


def main():
    mode = sys.argv[1] if sys.argv[1:2] in (["--timings"], ["--step-timings"]) else None
    root = Path(sys.argv[2]).resolve() if mode and len(sys.argv) > 2 else ROOT
    if not (root / "openset_rcnn_tpu_torch" / "csrc").is_dir() or not CONFIG.exists():
        print("chip_smoke: run from the root of a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from openset_rcnn_tpu_torch import _native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    import importlib.util
    import shutil

    have = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "PIL", "triton")}
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}; python {sys.version.split()[0]}; importable "
          f"{json.dumps(have)}; g++ {shutil.which('g++')}", flush=True)
    if mode == "--step-timings":
        # as this script ran the parent's entry points: TF32 and bf16 reduced-precision reductions off process-wide
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    else:
        from openset_rcnn_tpu_torch.device import numerics_flags

        print("process-wide numerics flags, left at PyTorch's defaults: " + json.dumps(numerics_flags()), flush=True)
    dev = torch.device("cuda", 0)

    seconds, logs = _native.build()
    print(f"build: {seconds:.1f} s for {', '.join(logs) or 'nothing (already built)'}", flush=True)
    for name, log in logs.items():
        kernel = ""
        for line in log.splitlines():
            if "Function properties for" in line or "Compiling entry function" in line:
                kernel = ptxas_kernel(line)
            if "registers" in line or "spill" in line:
                print(f"  {name} {kernel}: {line.strip()}")

    if mode == "--timings":
        print(f"timings of the kernels of {root}: " + json.dumps(timings(torch, dev)))
        return 0
    if mode == "--step-timings":
        print(f"step timings of {root}: " + json.dumps(step_timings(torch, dev)))
        return 0
    kernels = [phase_roi_align(torch, dev), phase_nms(torch, dev), phase_iou_match(torch, dev),
               phase_roi_align_bwd(torch, dev), phase_roi_align_adaptive(torch, dev),
               phase_roi_align_bwd_adaptive(torch, dev)]
    launch_floor = phase_launch_floor(torch, dev)
    paths = {}
    window, paths["window"] = phase_roi_align_window(torch, dev)
    kernels += [phase_roi_align_bwd_bf16(torch, dev), window, phase_frozen_bn(torch, dev)]
    phase_reference(torch, dev, load_cfg(), "f32", bf16=False)
    phase_reference(torch, dev, load_cfg(CONFIG_BF16), "bf16", bf16=True)
    phase_reference(torch, dev, load_cfg(CONFIG_BF16, ROI_ALIGN_IMPL="pallas"), "bf16, ROI_ALIGN_IMPL pallas",
                    bf16=True)
    phase_train_reference(torch, dev, load_cfg(), "f32", bf16=False)
    phase_train_reference(torch, dev, load_cfg(CONFIG_BF16), "bf16", bf16=True)
    phase_train_reference(torch, dev, load_cfg(CONFIG_BF16, ROI_ALIGN_IMPL="pallas"),
                          "bf16, ROI_ALIGN_IMPL pallas", bf16=True, wide=True)
    phase_reference(torch, dev, load_cfg(CONFIG_PARITY), "parity", bf16=False)
    phase_train_reference(torch, dev, load_cfg(CONFIG_PARITY), "parity", bf16=False)
    for name, config in (("swin", CONFIG_SWIN), ("vit", CONFIG_VIT)):
        for dtype, bf16 in (("float32", False), ("bfloat16", True)):
            label = f"{name} {'bf16' if bf16 else 'f32'}"
            phase_reference(torch, dev, load_cfg(config, DTYPE=dtype), label, bf16=bf16)
            phase_train_reference(torch, dev, load_cfg(config, DTYPE=dtype), label, bf16=bf16)
    results = {}
    paths["serve"], results["serve"] = phase_serve(torch, dev, load_cfg(), "serve")
    paths["train"], results["train"] = phase_train(torch, dev, load_cfg(), "train", TRAIN_BATCH)
    paths["train_remat"], results["train_remat"] = phase_train_remat(torch, dev, load_cfg(), results["train"])
    paths["serve_swin"], results["serve_swin"] = phase_serve(torch, dev, load_cfg(CONFIG_SWIN), "serve_swin")
    paths["serve_vit"], results["serve_vit"] = phase_serve(torch, dev, load_cfg(CONFIG_VIT), "serve_vit")
    paths["train_swin"], results["train_swin"] = phase_train(torch, dev, load_cfg(CONFIG_SWIN), "train_swin",
                                                             TRAIN_BATCH)
    paths["train_vit"], results["train_vit"] = phase_train(torch, dev, load_cfg(CONFIG_VIT), "train_vit", TRAIN_BATCH)
    paths["train_parity"], results["train_parity"] = phase_train(torch, dev, load_cfg(CONFIG_PARITY),
                                                                 "train_parity", TRAIN_BATCH)
    paths["serve_bf16"], results["serve_bf16"] = phase_serve(torch, dev, load_cfg(CONFIG_BF16), "serve_bf16")
    paths["eval"], results["eval"] = phase_eval(torch, dev, load_cfg(CONFIG_BF16), load_cfg(),
                                                results["serve_bf16"]["img_per_s"])
    paths["parity_eval"], results["parity_eval"] = phase_parity_eval(torch, dev, load_cfg(CONFIG_PARITY))
    paths["train_bf16"], results["train_bf16"] = phase_train(torch, dev, load_cfg(CONFIG_BF16), "train_bf16",
                                                             TRAIN_BATCH_BF16, calibrate=True)
    paths["do_train"], results["do_train"] = phase_do_train(torch, dev, results["train_bf16"]["img_per_s"])
    tool_paths, tool_results = phase_tools(torch, dev)
    paths.update(tool_paths)
    results.update(tool_results)
    mp_paths, mp_results = phase_multiprocess(torch, dev)
    paths.update(mp_paths)
    results.update(mp_results)
    # launches: from the path of this slice that runs the kernel (eval: K1,
    # K4; train: K2 f32, K3; train_bf16: K2 bf16; the adaptive modes of K1
    # and K2 f32: parity_eval and train_parity; K5, which no path of the
    # model runs: its own call; FrozenBN's: eval)
    home = {"roi_align_fwd": "eval", "nms_keep": "eval", "roi_align_bwd": "train", "iou_match": "train",
            "roi_align_bwd_bf16": "train_bf16", "roi_align_window": "window",
            "roi_align_fwd_adaptive": "parity_eval", "roi_align_bwd_adaptive": "train_parity",
            "frozen_bn_act": "eval"}
    for k in kernels:
        k["launches"] = paths[home[k["name"]]][k["name"]]
        k["launches_by_path"] = {p: launches[k["name"]] for p, launches in paths.items()}
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launches_by_path")
    for label, result in results.items():
        print(f"{label}: " + json.dumps(result))
    print("launch floor: " + json.dumps(launch_floor))
    # the keys every entry carries first, then a kernel's own extra figures
    print(json.dumps({"kernels": [{**{k: entry[k] for k in keys}, **entry} for entry in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
