"""``roi_align_bwd_roofline.<suffix>``: K2's share of its roofline, in %:
the least time the card could take for the calls' bytes (``counts/``) over
the device time of the configuration's backward kernel
(``roi_align_bwd_bf16_kernel`` under ``TPU.ROI_ALIGN_BWD pallas_bf16``,
else ``roi_align_bwd_kernel``) in the profiled stretch. Each call takes a
training step's sampled RoIs."""
from perfbench.counts import roi_align
from perfbench.harness.trace import kernel_seconds
from perfbench.metrics._common import inputs


def read(run, suffix):
    got = inputs(run, "batch")
    if got is None or run.profile is None:
        return None
    cfg = run.config["cfg"]
    acc = cfg["TPU"]["ROI_ALIGN_BWD"]
    secs, calls = kernel_seconds(run.profile, "roi_align_bwd_bf16_kernel" if acc == "pallas_bf16"
                                 else "roi_align_bwd_kernel")
    if not calls or secs <= 0:
        return None
    bucket = tuple(cfg["TPU"]["TRAIN_BUCKET"])
    rois = cfg["MODEL"]["ROI_HEADS"]["BATCH_SIZE_PER_IMAGE"]
    bound = roi_align.bound_s(roi_align.bwd_bytes(got[0], rois, bucket, acc))
    return 100.0 * calls * bound / secs
