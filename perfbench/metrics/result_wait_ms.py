"""``result_wait_ms.<suffix>``: host ms per batch the eval loop waited for
a batch's detections to land on the host (``timings["wait_ms"]``), a mean
per batch of the traced window."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "timings")
    return None if got is None else mean(got[0].get("wait_ms", []))
