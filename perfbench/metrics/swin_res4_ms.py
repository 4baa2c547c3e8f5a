"""``swin_res4_ms.<suffix>``: device ms of a serving batch from the
program's "backbone.res3" mark to its "backbone.res4" mark: the patch
merging into res4, Swin's res4 blocks (18 of Swin-B's 24, most of its
products) and their output norm, a mean over the traced window. CUDA events
at ``Predictor``'s ``mark`` callbacks; None where the trunk gives no such
marks."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "marks")
    return None if got is None else mean(got[0].between_ms("backbone.res3", "backbone.res4"))
