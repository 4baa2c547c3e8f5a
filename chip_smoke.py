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
     N=1000 (dense overlapping boxes, ~20% invalid), exactly, and times both;
  5. iou_match (K3): the fused IoU+matcher kernel against its plain version
     at the training shapes (B=4, G=100 padded GT, R=93,093 anchors of the
     832x1344 bucket), with an image without valid GT, a zero-area GT and
     integer coordinates that make IoUs tie: all four outputs exactly equal;
  6. roi_align_bwd (K2, f32 accumulators): against its plain version at
     B=4 x 512 RoIs, C=256 on the 832x1344 pyramid, within
     1e-5 * max(1, max|want|) (atomics reorder the sums);
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
     unchanged, trainable ones moved, and one step under torch.profiler
     (device idle share, device time by kernel);
 12. serve_bf16 and train_bf16: the same on the production bf16 config
     (batch 8 serving; batch 16 training, its own IMS_PER_BATCH), each with
     one profiled batch or step.
Each path is driven with every launch count at 0 just before it and read
just after. Then it prints one JSON line of kernel figures and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises. Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""
import json
import math
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


def phase_nms(torch, dev):
    from openset_rcnn_tpu_torch.ops.nms import nms_keep, nms_keep_plain

    g = torch.Generator(device=dev).manual_seed(2)
    total = dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0)
    for N in (2000, 1000):  # the cascade's known and unknown branches
        boxes, valid = nms_case(torch, g, N, dev)
        got = nms_keep(boxes, valid, 0.5)
        want = nms_keep_plain(boxes, valid, 0.5)
        check(torch.equal(got, want), f"nms_keep kernel vs plain at N={N}: "
              f"{int((got != want).sum())} of {got.numel()} differ")
        ms = time_ms(torch, lambda: nms_keep(boxes, valid, 0.5), 20)
        plain_ms = time_ms(torch, lambda: nms_keep_plain(boxes, valid, 0.5), 2)
        # the IoU tests this data needs: each kept box against the valid boxes after it
        later_valid = valid.flip(1).cumsum(1).flip(1) - valid.long()
        tests = int(later_valid[got].sum())
        n_bytes = boxes.numel() * 4 + valid.numel() + got.numel()
        b_ms, b_by = bound(n_bytes, tests * IOU_FLOPS)
        print(f"nms_keep: B={BATCH} N={N}: kept {int(got.sum())} of {int(valid.sum())} valid, exact; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.6f} ms ({b_by}); "
              f"{int(got.sum(1).max())} dependent steps in the longest image", flush=True)
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bytes"] += n_bytes
        total["flops"] += tests * IOU_FLOPS
    bound_ms, bound_by = bound(total["bytes"], total["flops"])
    return dict(name="nms_keep", route="cuda", source="openset_rcnn_tpu_torch/csrc/nms_keep.cu",
                replaces="openset_rcnn_tpu/ops/pallas/nms_kernel.py:61", max_abs_err=0.0,
                ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


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
    profile = profile_step(torch, lambda: predictor(images, image_hw))
    print(f"{label}: {ms:.2f} ms/batch ({BATCH * 1e3 / ms:.2f} img/s) over {SERVE_BATCHES} batches "
          f"(per batch {[round(x, 2) for x in batch_ms]}; host clock {wall:.2f} ms/batch); "
          f"peak memory {peak_gb:.2f} GB; valid detections per image {out.valid.sum(1).tolist()}, "
          f"valid proposals {int(v.sum())}, known overflow {out.known_overflow.tolist()}", flush=True)
    print(f"{label} stages (ms): " + json.dumps({k: round(x, 3) for k, x in stages.items()}), flush=True)
    print(f"{label}: cascade with kernel NMS == cascade with plain NMS; launches " + json.dumps(launches), flush=True)
    print(f"{label} profile: " + json.dumps(profile), flush=True)
    return launches, dict(ms_per_batch=ms, img_per_s=BATCH * 1e3 / ms, stages_ms=stages, peak_gb=peak_gb,
                          device_idle_share=profile["idle_share"])


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


def bench_batch(torch, batch_size, max_gt):
    """The synthetic 832x1344 training batch of bench.py:105-128, on the host:
    20 GT boxes per image, uniform in position and size, true size 800x1333."""
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
    images = rng.uniform(0, 255, (batch_size, *BUCKET, 3)).astype(np.float32)
    return ImageBatch(torch.from_numpy(images), torch.tensor([[800.0, 1333.0]] * batch_size),
                      GroundTruth(torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid)))


def phase_iou_match(torch, dev):
    from openset_rcnn_tpu_torch.models.detector import ModelSpec, compute_anchors
    from openset_rcnn_tpu_torch.ops.iou_match import iou_match, iou_match_plain

    cfg = load_cfg()
    anchors, _ = compute_anchors(ModelSpec.from_cfg(cfg), BUCKET)
    anchors[::3] = anchors[::3].round()  # integer anchors against integer GT: exact IoU ties
    anchors = torch.from_numpy(anchors).to(dev)
    gt = bench_batch(torch, TRAIN_BATCH, cfg.TPU.MAX_GT_PER_IMAGE).gt
    boxes, valid = gt.boxes.clone(), gt.valid.clone()
    boxes[1] = boxes[1].round()  # integer GT
    boxes[1, 5] = boxes[1, 4]    # a duplicate GT row: ties between GT
    boxes[2, 1] = torch.tensor([100.0, 100.0, 100.0, 160.0])  # zero area
    valid[3] = False             # an image without valid GT
    boxes, valid = boxes.to(dev), valid.to(dev)
    got = iou_match(anchors, boxes, valid)
    want = iou_match_plain(anchors, boxes, valid)
    torch.cuda.synchronize()
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        check(torch.equal(a, b), f"iou_match kernel vs plain: {name} differs in {int((a != b).sum())} places")
    max_abs = max(float((got.max_iou - want.max_iou).abs().max()),
                  float((got.matched_boxes - want.matched_boxes).abs().max()))
    check(bool((want.max_iou[3] == -1).all()) and not bool(want.rescued[3].any()), "iou_match: image without GT")
    m = want.max_iou[1]
    n_tied = int((m > 0).sum()) - len(torch.unique(m[m > 0]))
    check(n_tied > 0 and int(want.rescued.sum()) > 0, "iou_match: the inputs reach no ties or no rescue")
    ms = time_ms(torch, lambda: iou_match(anchors, boxes, valid), 20)
    plain_ms = time_ms(torch, lambda: iou_match_plain(anchors, boxes, valid), 3)
    B, G = boxes.shape[:2]
    R = anchors.shape[0]
    # one IoU per anchor and valid GT; anchors and GT read once, four outputs written once
    n_bytes = anchors.numel() * 4 + boxes.numel() * 4 + valid.numel() + B * R * (4 + 4 + 1 + 16)
    n_pairs = int(valid.sum()) * R
    bound_ms, bound_by = bound(n_bytes, n_pairs * IOU_FLOPS)
    print(f"iou_match: B={B} G={G} R={R}, {int(valid.sum())} valid GT, {n_pairs} anchor-GT pairs; "
          f"all four outputs exact ({int(want.rescued.sum())} rescued anchors, {n_tied} tied IoUs in the "
          f"integer image); kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.6f} ms ({bound_by})",
          flush=True)
    return dict(name="iou_match", route="cuda", source="openset_rcnn_tpu_torch/csrc/iou_match.cu",
                replaces="openset_rcnn_tpu/ops/pallas/iou_match_kernel.py:100", max_abs_err=max_abs,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_roi_align_bwd(torch, dev):
    from openset_rcnn_tpu_torch.ops.roi_align import assign_levels, roi_align_bwd, roi_align_bwd_plain

    g = torch.Generator(device=dev).manual_seed(5)
    B, R, C, P, S = TRAIN_BATCH, TRAIN_ROIS, 256, 7, 2
    H, W = BUCKET
    level_hw = [(math.ceil(H / s), math.ceil(W / s)) for s in STRIDES]
    boxes = roi_boxes(torch, g, B, R, dev)
    levels = assign_levels(boxes)
    cot = torch.randn(B, R, P, P, C, generator=g, device=dev)
    got = roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, S)
    want = roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, S)
    torch.cuda.synchronize()
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    max_abs = max(float((a - w).abs().max()) for a, w in zip(got, want))
    check(max_abs <= BWD_TOL * scale, f"roi_align_bwd kernel vs plain: max abs {max_abs} > {BWD_TOL} * {scale}")
    per_level = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    ms = time_ms(torch, lambda: roi_align_bwd(cot, boxes, levels, level_hw, STRIDES, P, S), 20)
    plain_ms = time_ms(torch, lambda: roi_align_bwd_plain(cot, boxes, levels, level_hw, STRIDES, P, S), 2)
    # the cotangent, boxes and levels read once; the f32 accumulators written once
    acc_bytes = sum(w.numel() * 4 for w in want)
    n_bytes = cot.numel() * 4 + boxes.numel() * 4 + levels.numel() * 4 + acc_bytes
    bound_ms, bound_by = bound(n_bytes, cot.numel() * (S * S * ROI_BWD_FLOPS_PER_SAMPLE + 1))
    print(f"roi_align_bwd: B={B} R={R} C={C} RoIs per level {per_level}; max abs err {max_abs:.3e} "
          f"(limit {BWD_TOL * scale:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}, {n_bytes / 1e9:.3f} GB of which {acc_bytes / 1e9:.3f} GB accumulators)", flush=True)
    return dict(name="roi_align_bwd", route="cuda", source="openset_rcnn_tpu_torch/csrc/roi_align_bwd.cu",
                replaces="openset_rcnn_tpu/ops/pallas/roi_align_v2.py:487", max_abs_err=max_abs,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


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
    print(f"{label}: {ms:.2f} ms/step ({batch_size * 1e3 / ms:.2f} img/s) at batch {batch_size} over {TRAIN_STEPS} "
          f"steps (per step {[round(x, 2) for x in step_ms]}; host clock {wall:.2f} ms/step); peak memory "
          f"{peak_gb:.2f} GB; {len(frozen)} frozen parameters and {len(buffers)} buffers unchanged, "
          f"{len(before)} trainable parameters moved", flush=True)
    print(f"{label} stages (ms): " + json.dumps({k: round(x, 3) for k, x in stages.items()}), flush=True)
    print(f"{label}: last timed step " + json.dumps({k: round(float(v), 6) for k, v in last.items()}), flush=True)
    print(f"{label}: launches over the timed steps " + json.dumps(launches), flush=True)
    print(f"{label} profile: " + json.dumps(profile), flush=True)
    return launches, dict(ms_per_step=ms, img_per_s=batch_size * 1e3 / ms, batch=batch_size, stages_ms=stages,
                          peak_gb=peak_gb, device_idle_share=profile["idle_share"])


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
           for name in ("roi_align_fwd_kernel", "roi_align_bwd_kernel", "roi_align_bwd_bf16_kernel", "iou_match_pass",
                        "nms_keep")}
    return dict(step_ms=step_ms, device_busy_ms=busy_ms, idle_share=max(0.0, 1.0 - busy_ms / step_ms),
                kernel_ms_total=sum(ms for _, ms in kernels), own_kernels_ms=own,
                top_kernels_ms=[[key[:60], round(ms, 3)] for key, ms in kernels[:8]])


def main():
    if not (ROOT / "openset_rcnn_tpu_torch" / "csrc").is_dir() or not CONFIG.exists():
        print("chip_smoke: run from the root of a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from openset_rcnn_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}; f32 convs and matmuls without TF32, bf16 "
          "matmuls without reduced-precision reductions", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 GEMMs sum in f32 throughout, as XLA's bf16 dots do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)

    seconds, logs = _build.build()
    print(f"build: {seconds:.1f} s for {', '.join(logs) or 'nothing (already built)'}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = [phase_roi_align(torch, dev), phase_nms(torch, dev), phase_iou_match(torch, dev),
               phase_roi_align_bwd(torch, dev)]
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
    paths["train_bf16"], results["train_bf16"] = phase_train(torch, dev, load_cfg(CONFIG_BF16), "train_bf16",
                                                             TRAIN_BATCH_BF16, calibrate=True)
    # launches: from the path that brought the kernel (serve: K1, K4; train:
    # K2 f32, K3; train_bf16: K2 bf16; K5, which no path of the model runs:
    # its own call)
    home = {"roi_align_fwd": "serve", "nms_keep": "serve", "roi_align_bwd": "train", "iou_match": "train",
            "roi_align_bwd_bf16": "train_bf16", "roi_align_window": "window"}
    for k in kernels:
        k["launches"] = paths[home[k["name"]]][k["name"]]
        k["launches_by_path"] = {p: launches[k["name"]] for p, launches in paths.items()}
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launches_by_path")
    for label, result in results.items():
        print(f"{label}: " + json.dumps(result))
    # the keys every entry carries first, then a kernel's own extra figures
    print(json.dumps({"kernels": [{**{k: entry[k] for k in keys}, **entry} for entry in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
