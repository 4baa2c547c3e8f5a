"""``data_wait_ms.<suffix>``: host ms the step loop waited in ``next()`` of
``device_prefetch`` (the loader's decode, transform and staging not hidden
behind the device), a mean per step of the traced window. Harness span."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "spans")
    return None if got is None else mean(got[0].ms.get("data_wait", []))
