"""``host_ms.<suffix>``: host ms per frame in the test transform,
``collate`` and ``finalize_serve_image``, a mean per frame of the traced
window. Harness spans."""
from perfbench.metrics._common import inputs


def read(run, suffix):
    got = inputs(run, "spans", "images")
    if got is None:
        return None
    spans, frames = got
    total = sum(sum(spans.ms.get(k, [])) for k in ("transform", "collate", "finalize"))
    return total / frames if frames else None
