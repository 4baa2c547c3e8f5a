"""``backbone_ms.<suffix>``: device ms from a step's or batch's start to the
program's "backbone" mark (preprocess, trunk, FPN), a mean over the traced
window. CUDA events at the program's ``mark`` callbacks."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "marks")
    return None if got is None else mean(got[0].between_ms("begin", "backbone"))
