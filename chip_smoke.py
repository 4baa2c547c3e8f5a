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
  9. references: the serving path and one training step on the GPU against
     the same seeded model on the CPU (plain versions) on a 2x64x96 batch:
     f32 (configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml), bf16
     (configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml) and bf16 with
     TPU.ROI_ALIGN_IMPL pallas;
 10. serve: Predictor on the f32 config at 832x1344, batch 8, seeded random
     weights; warm-up, then timed batches with CUDA events, the stage split,
     launch counts, output checks, and the cascade with kernel NMS against
     the cascade with plain NMS;
 11. train: Trainer on the f32 config at 832x1344, batch 4, on the synthetic
     batch of bench.py (20 GT boxes per image); timed steps, the stage split,
     launch counts, finite losses, frozen parameters and buffers bitwise
     unchanged, trainable ones moved, one step under torch.profiler (device
     idle share, device time by kernel), and two steps from one state on
     one batch giving bitwise equal parameters (a gate);
 12. serve_bf16: the same on the production bf16 config (batch 8);
 13. eval: the evaluation path, do_test, on the production bf16 config over
     44 seeded synthetic records (28 landscape 800x1200, 16 portrait
     1200x800, 2-6 GT boxes each over the VOC-COCO classes, known and
     unknown), decoded in memory and supplied through the transform's
     read_image: both buckets, three full landscape batches and a padded one
     of 4, two full portrait batches; the metric dict, eval img/s of the
     whole loop against Predictor-alone img/s, host ms per batch, the device
     idle share of one profiled pass, one eval batch under
     torch.cuda.set_sync_debug_mode("error"); then on the f32 config the
     fused cascade (K4) against the exact host cascade on every image that
     did not overflow, with equal VOC metric dicts, do_test with
     TPU.EVAL_FUSED false, and eval_type="proposals" over two batches;
 14. train_bf16: Trainer on the production config at batch 16 (its own
     IMS_PER_BATCH), with one profiled step.
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

times only K3 and K2 f32 at the shapes of phases 5 and 6 (event and device
time, no gates), with the openset_rcnn_tpu_torch package of ROOT (default:
this checkout), so that two versions of the kernels are timed by one script
in one call: run it on a checkout of each.

    python3 chip_smoke.py --step-timings [ROOT]

times only the train (f32, batch 4) and train_bf16 (batch 16) steps with
ROOT's package, with TF32 and bf16 reduced-precision reductions turned off
process-wide as this script did before the entry points set them, and
prints the device time by kernel of one profiled f32 step and whether two
steps repeat bitwise (no gates): run it on a checkout of each version.
"""
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


def phase_roi_align(torch, dev):
    from openset_rcnn_tpu_torch.ops.roi_align import assign_levels, roi_align, roi_align_plain

    g = torch.Generator(device=dev).manual_seed(1)
    H, W = BUCKET
    R = 4 * 1000 + math.ceil(H / 64) * math.ceil(W / 64)  # per-level top-1000 over P2-P6
    C = 256
    feats = [
        torch.randn(BATCH, math.ceil(H / s), math.ceil(W / s), C, generator=g, device=dev).to(torch.bfloat16)
        for s in STRIDES
    ]
    boxes = roi_boxes(torch, g, BATCH, R, dev)
    levels = assign_levels(boxes)
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


def counted():
    """The wrappers that count their kernel launches, by kernel name."""
    from openset_rcnn_tpu_torch.ops.iou_match import iou_match
    from openset_rcnn_tpu_torch.ops.nms import nms_keep
    from openset_rcnn_tpu_torch.ops.roi_align import roi_align, roi_align_bwd, roi_align_bwd_bf16, roi_align_window

    return {"roi_align_fwd": roi_align, "roi_align_bwd": roi_align_bwd, "roi_align_bwd_bf16": roi_align_bwd_bf16,
            "iou_match": iou_match, "nms_keep": nms_keep, "roi_align_window": roi_align_window}


def reset_launches():
    for fn in counted().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in counted().items()}


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
    g = torch.Generator(device=dev).manual_seed(4)
    H, W = BUCKET
    images = torch.randint(0, 256, (BATCH, H, W, 3), dtype=torch.uint8, generator=g, device=dev)
    image_hw = torch.tensor(IMAGE_HW[:BATCH], dtype=torch.float32)
    for _ in range(SERVE_WARMUP):
        predictor(images, image_hw)
    torch.cuda.synchronize()
    print(f"{label}: model built ({cfg.TPU.DTYPE}) and {SERVE_WARMUP} warm-up batches in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: counts at 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(SERVE_BATCHES + 1)]
    wall = time.perf_counter()
    events[0].record()
    for i in range(SERVE_BATCHES):
        out = predictor(images, image_hw)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - wall) * 1e3 / SERVE_BATCHES
    launches = read_launches()
    want = {name: 0 for name in launches}
    want.update(roi_align_fwd=SERVE_BATCHES, nms_keep=2 * SERVE_BATCHES)
    check(launches == want, f"{label} launches {launches}, expected {want}")
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
    print(f"{label}: cascade with kernel NMS == cascade with plain NMS; launches " + json.dumps(launches), flush=True)
    print(f"{label} profile: " + json.dumps(profile), flush=True)
    print(f"{label}: numerics flags inside a serve batch (the backbone's mark) {json.dumps(flags['inside'])}; "
          f"the caller's, before and after {json.dumps(flags['outside'])}", flush=True)
    return launches, dict(ms_per_batch=ms, img_per_s=BATCH * 1e3 / ms, stages_ms=stages, peak_gb=peak_gb,
                          device_idle_share=profile["idle_share"], flags_inside=flags["inside"])


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
    import ctypes

    from openset_rcnn_tpu_torch.ops import _build

    lib = _build.load("launch_floor", {"empty_launch": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for label, blocks, threads in (("1x32", 1, 32), (f"{4 * sms}x256", 4 * sms, 256)):
        run = lambda: _build.check(lib, "empty_launch", lib.empty_launch(blocks, threads, stream))
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


def timings(torch, dev):
    """K3 and K2 f32 only, no gates (``--timings``): the wrapper's time
    (CUDA events) and the device time per call (profiler)."""
    from openset_rcnn_tpu_torch.ops.roi_align import roi_align_bwd

    out = {}
    for B in (TRAIN_BATCH, TRAIN_BATCH_BF16):
        out[f"iou_match_b{B}"] = iou_timings(torch, *iou_case(torch, dev, B))
    H, W = BUCKET
    level_hw = [(math.ceil(H / s), math.ceil(W / s)) for s in STRIDES]
    for label, B, boxes, levels, cot in bwd_cases(torch, dev):
        run = lambda: roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, 7, 2)
        events = device_events(torch, run, 20)
        out[f"roi_align_bwd_{label}_b{B}"] = dict(
            ms=time_ms(torch, run, 20), device_ms=sum(t for _, t, _ in events) / 20,
            kernel_device_ms=device_ms(torch, run, 20, ("roi_align_bwd_kernel",))["roi_align_bwd_kernel"],
            ops_per_call=sum(count for _, _, count in events) / 20)
        del cot
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
    the phase's seven steps."""
    from openset_rcnn_tpu_torch.models.resnet import FrozenBN

    def hook(bn, args):
        x = args[0].float()
        bn.mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, FrozenBN)]
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
    print(f"{label}: model built ({cfg.TPU.DTYPE}, RoIAlign backward {cfg.TPU.ROI_ALIGN_BWD}"
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
    bwd = "roi_align_bwd_bf16" if cfg.TPU.ROI_ALIGN_BWD == "pallas_bf16" else "roi_align_bwd"
    want = {name: 0 for name in launches}
    want.update({"roi_align_fwd": TRAIN_STEPS, bwd: TRAIN_STEPS, "iou_match": 2 * TRAIN_STEPS})
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
    unmoved = [n for n, p in model.named_parameters() if n in before and torch.equal(p, before[n])]
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
          f"{len(before)} trainable parameters moved", flush=True)
    print(f"{label} stages (ms): " + json.dumps({k: round(x, 3) for k, x in stages.items()}), flush=True)
    print(f"{label}: last timed step " + json.dumps({k: round(float(v), 6) for k, v in last.items()}), flush=True)
    print(f"{label}: launches over the timed steps " + json.dumps(launches), flush=True)
    print(f"{label} profile: " + json.dumps(profile), flush=True)
    return launches, dict(ms_per_step=ms, img_per_s=batch_size * 1e3 / ms, batch=batch_size, stages_ms=stages,
                          peak_gb=peak_gb, device_idle_share=profile["idle_share"],
                          repeat_bitwise=not differ, flags_inside=flags["inside"])


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
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(bool(spans), "profile: the profiler saw no device activity")
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy_us, lo, hi = busy_us + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy_ms = (busy_us + hi - lo) / 1e3
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
          f"({evalcore_binding.library_path()})", flush=True)

    # the main path, through the user's entry point: counts at 0 just before, read just after
    reset_launches()
    metrics = do_test(cfg, datasets=[EVAL_DATASET], transform=transform)[EVAL_DATASET]
    torch.cuda.synchronize()
    launches = read_launches()
    n_batches = len(batches)
    want = {name: 0 for name in launches}
    want.update(roi_align_fwd=n_batches, nms_keep=2 * n_batches)
    check(launches == want, f"eval launches {launches}, expected {want}")
    check(set(metrics) == set(voc_keys) and all(math.isfinite(v) for v in metrics.values()),
          f"eval (do_test, fused): metrics {metrics}, expected finite values of {voc_keys}")
    print(f"eval: do_test on {EVAL_DATASET} ({cfg.TPU.DTYPE}, fused cascade), {len(records)} images: "
          + json.dumps(metrics) + "; launches " + json.dumps(launches), flush=True)

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
    from openset_rcnn_tpu_torch.ops import _build

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

    seconds, logs = _build.build()
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
               phase_roi_align_bwd(torch, dev)]
    launch_floor = phase_launch_floor(torch, dev)
    paths = {}
    window, paths["window"] = phase_roi_align_window(torch, dev)
    kernels += [phase_roi_align_bwd_bf16(torch, dev), window]
    phase_reference(torch, dev, load_cfg(), "f32", bf16=False)
    phase_reference(torch, dev, load_cfg(CONFIG_BF16), "bf16", bf16=True)
    phase_reference(torch, dev, load_cfg(CONFIG_BF16, ROI_ALIGN_IMPL="pallas"), "bf16, ROI_ALIGN_IMPL pallas",
                    bf16=True)
    phase_train_reference(torch, dev, load_cfg(), "f32", bf16=False)
    phase_train_reference(torch, dev, load_cfg(CONFIG_BF16), "bf16", bf16=True)
    phase_train_reference(torch, dev, load_cfg(CONFIG_BF16, ROI_ALIGN_IMPL="pallas"),
                          "bf16, ROI_ALIGN_IMPL pallas", bf16=True, wide=True)
    results = {}
    paths["serve"], results["serve"] = phase_serve(torch, dev, load_cfg(), "serve")
    paths["train"], results["train"] = phase_train(torch, dev, load_cfg(), "train", TRAIN_BATCH)
    paths["serve_bf16"], results["serve_bf16"] = phase_serve(torch, dev, load_cfg(CONFIG_BF16), "serve_bf16")
    paths["eval"], results["eval"] = phase_eval(torch, dev, load_cfg(CONFIG_BF16), load_cfg(),
                                                results["serve_bf16"]["img_per_s"])
    paths["train_bf16"], results["train_bf16"] = phase_train(torch, dev, load_cfg(CONFIG_BF16), "train_bf16",
                                                             TRAIN_BATCH_BF16, calibrate=True)
    # launches: from the path of this slice that runs the kernel (eval: K1,
    # K4; train: K2 f32, K3; train_bf16: K2 bf16; K5, which no path of the
    # model runs: its own call)
    home = {"roi_align_fwd": "eval", "nms_keep": "eval", "roi_align_bwd": "train", "iou_match": "train",
            "roi_align_bwd_bf16": "train_bf16", "roi_align_window": "window"}
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
