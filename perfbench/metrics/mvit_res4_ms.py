"""``mvit_res4_ms.<suffix>``: device ms of a serving batch from the
program's "backbone.res3" mark to its "backbone.res4" mark: MViT's stage 3
(36 of MViTv2-L's 48 blocks, most of its products, the global block 43
included) and its output norm, a mean over the traced window. CUDA events at
``Predictor``'s ``mark`` callbacks; None where the trunk gives no such
marks."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "marks")
    return None if got is None else mean(got[0].between_ms("backbone.res3", "backbone.res4"))
