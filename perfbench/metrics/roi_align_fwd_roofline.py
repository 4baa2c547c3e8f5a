"""``roi_align_fwd_roofline.<suffix>``: K1's share of its roofline, in %:
the least time the card could take for the calls' bytes (``counts/``) over
the device time of ``roi_align_fwd_kernel`` in the profiled stretch. Each
call pools every proposal of a serving batch."""
from perfbench.counts import model, roi_align
from perfbench.harness.trace import kernel_seconds
from perfbench.metrics._common import inputs


def read(run, suffix):
    got = inputs(run, "batch")
    if got is None or run.profile is None:
        return None
    secs, calls = kernel_seconds(run.profile, "roi_align_fwd_kernel")
    if not calls or secs <= 0:
        return None
    cfg = run.config["cfg"]
    bucket = tuple(cfg["TPU"]["TEST_BUCKET"])
    rois = model.proposals_per_image(*bucket, cfg["MODEL"]["RPN"]["PRE_NMS_TOPK_TEST"])
    bound = roi_align.bound_s(roi_align.fwd_bytes(got[0], rois, bucket))
    return 100.0 * calls * bound / secs
