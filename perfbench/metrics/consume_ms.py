"""``consume_ms.<suffix>``: host ms per batch in the eval loop's finalize
and evaluator ``process`` (``inference_on_dataset``'s own
``timings["consume_ms"]``), a mean per batch of the traced window."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "timings")
    return None if got is None else mean(got[0].get("consume_ms", []))
