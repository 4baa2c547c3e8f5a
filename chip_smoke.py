#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openset_rcnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

In order it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from openset_rcnn_tpu_torch/csrc with nvcc;
  3. RoIAlign: holds the kernel against its plain PyTorch version at the
     serving shapes (B=8, R=4273 RoIs per image, C=256, bf16 P2-P5 of an
     832x1344 canvas), elementwise within atol 2e-5 + rtol 1e-5, and times both;
  4. NMS: holds the kernel against its plain version at B=8 x N=2000 and
     N=1000 (dense overlapping boxes, ~20% invalid), exactly, and times both;
  5. reference: the whole path on the GPU against the same seeded model on
     the CPU (plain versions) on a small batch;
  6. serve: Predictor on configs/VOC-COCO/openset_rcnn_R50_FPN_128k.yaml at
     832x1344, batch 8, seeded random weights; warm-up, then timed batches with
     CUDA events, the stage split, launch counts, output checks, and the
     cascade with kernel NMS against the cascade with plain NMS.
Then it prints one JSON line of kernel figures and, last,
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
BATCH = 8
BUCKET = (832, 1344)
STRIDES = (4, 8, 16, 32)
ATOL, RTOL = 2e-5, 1e-5  # RoIAlign kernel vs plain, elementwise
# NVIDIA H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
ROI_FLOPS_PER_OUTPUT = 4 * 8 + 1  # per sample: 4 mul + 3 add + 1 accumulate; then the mean
IOU_FLOPS = 15                    # one IoU test of the greedy scan
SERVE_WARMUP, SERVE_BATCHES = 2, 5
# true (h, w) of the serve batch's images inside the bucket
IMAGE_HW = [[832, 1344], [800, 1333], [832, 1110], [600, 1344], [750, 1000], [832, 1344], [512, 768], [700, 1200]]


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
          f"max rel err {max_rel:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}, {bytes_moved / 1e9:.3f} GB)", flush=True)
    return dict(name="roi_align_fwd", route="cuda", source="openset_rcnn_tpu_torch/csrc/roi_align_fwd.cu",
                replaces="openset_rcnn_tpu/ops/pallas/roi_align_v2.py:269", max_abs_err=max_abs,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


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


def load_cfg():
    from openset_rcnn_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(str(CONFIG))
    # A random init regresses zero-size proposals (the IoU loss's saddle);
    # the config's init knob starts them at a positive size.
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0
    return cfg


def phase_reference(torch, dev):
    """The whole path on the GPU against the same seeded model on the CPU."""
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor

    cfg = load_cfg()
    g = torch.Generator().manual_seed(3)
    mean = torch.tensor(cfg.MODEL.PIXEL_MEAN)
    images = mean + (torch.rand(2, 64, 96, 3, generator=g) * 8.0 - 4.0)  # moderate activations
    image_hw = torch.tensor([[64.0, 96.0], [50.0, 70.0]])
    raw_cpu = Predictor(cfg, device="cpu", seed=0).raw(images, image_hw)
    raw_gpu = Predictor(cfg, seed=0).raw(images.to(dev), image_hw.to(dev))
    worst = 0.0
    for name in ("boxes", "objectness", "pred_iou", "centerness", "min_dist", "known_probs"):
        a, b = getattr(raw_gpu, name).cpu().double(), getattr(raw_cpu, name).double()
        err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        check(err <= 1e-3, f"reference: {name} GPU vs CPU scaled error {err:.3e}")
        worst = max(worst, err)
    check(torch.equal(raw_gpu.valid.cpu(), raw_cpu.valid), "reference: valid masks differ")
    print(f"reference: GPU vs CPU raw detections (2x64x96): worst scaled error {worst:.3e}, "
          f"{int(raw_cpu.valid.sum())} valid proposals, masks equal", flush=True)


def phase_serve(torch, dev):
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor
    from openset_rcnn_tpu_torch.ops.nms import nms_keep, nms_keep_plain
    from openset_rcnn_tpu_torch.ops.roi_align import roi_align

    cfg = load_cfg()
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
    print(f"serve: model built and {SERVE_WARMUP} warm-up batches in {time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: counts at 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    roi_align.launches = 0
    nms_keep.launches = 0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(SERVE_BATCHES + 1)]
    wall = time.perf_counter()
    events[0].record()
    for i in range(SERVE_BATCHES):
        out = predictor(images, image_hw)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - wall) * 1e3 / SERVE_BATCHES
    launches = {"roi_align_fwd": roi_align.launches, "nms_keep": nms_keep.launches}
    check(launches["roi_align_fwd"] == SERVE_BATCHES, f"roi_align launches {launches}")
    check(launches["nms_keep"] == 2 * SERVE_BATCHES, f"nms_keep launches {launches}")
    batch_ms = [events[i].elapsed_time(events[i + 1]) for i in range(SERVE_BATCHES)]
    ms = sum(batch_ms) / SERVE_BATCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # outputs
    D = cfg.MODEL.ROI_HEADS.UNKNOWN_TOPK + cfg.MODEL.ROI_HEADS.KNOWN_TOPK
    check(tuple(out.boxes.shape) == (BATCH, D, 4) and tuple(out.scores.shape) == (BATCH, D), "serve shapes")
    check(bool(torch.isfinite(out.boxes).all() and torch.isfinite(out.scores).all()), "non-finite detections")
    check(int(out.valid.sum()) > 0, "no detections")
    raw = predictor.raw(images, image_hw)
    v = raw.valid
    for name in ("boxes", "objectness", "min_dist", "known_probs"):
        check(bool(torch.isfinite(getattr(raw, name)[v]).all()), f"non-finite raw {name}")
    a, b = predictor.cascade(raw), predictor.cascade(raw, keep_fn=nms_keep_plain)
    for name in a._fields:
        check(torch.equal(getattr(a, name), getattr(b, name)), f"cascade {name}: kernel NMS != plain NMS")

    # stage split of one more batch
    marks = [("start", torch.cuda.Event(enable_timing=True))]
    marks[0][1].record()

    def mark(stage):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((stage, e))

    predictor(images, image_hw, mark=mark)
    torch.cuda.synchronize()
    stages = {s: marks[i][1].elapsed_time(e) for i, (s, e) in enumerate(marks[1:])}
    print(f"serve: {ms:.2f} ms/batch ({BATCH * 1e3 / ms:.2f} img/s) over {SERVE_BATCHES} batches "
          f"(per batch {[round(x, 2) for x in batch_ms]}; host clock {wall:.2f} ms/batch); "
          f"peak memory {peak_gb:.2f} GB; valid detections per image {out.valid.sum(1).tolist()}, "
          f"valid proposals {int(v.sum())}, known overflow {out.known_overflow.tolist()}", flush=True)
    print("serve stages (ms): " + json.dumps({k: round(x, 3) for k, x in stages.items()}), flush=True)
    print("serve: cascade with kernel NMS == cascade with plain NMS; launches " + json.dumps(launches), flush=True)
    return launches, dict(ms_per_batch=ms, img_per_s=BATCH * 1e3 / ms, stages_ms=stages, peak_gb=peak_gb)


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
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}; f32 convs and matmuls without TF32", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    seconds, logs = _build.build()
    print(f"build: {seconds:.1f} s for {', '.join(logs) or 'nothing (already built)'}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = [phase_roi_align(torch, dev), phase_nms(torch, dev)]
    phase_reference(torch, dev)
    launches, serve = phase_serve(torch, dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print("serve: " + json.dumps(serve))
    print(json.dumps({"kernels": [{k: entry[k] for k in keys} for entry in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
