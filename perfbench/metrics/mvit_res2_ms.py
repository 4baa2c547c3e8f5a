"""``mvit_res2_ms.<suffix>``: device ms of a serving batch from its start
to the program's "backbone.res2" mark: the preprocess, the patch embedding
and MViT's stage 1 (its two blocks on the finest grid: 56-token windows of
queries against k and v pooled 4x, and the output norm), a mean over the
traced window. CUDA events at ``Predictor``'s ``mark`` callbacks; None
where the trunk gives no such mark."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "marks")
    return None if got is None else mean(got[0].between_ms("begin", "backbone.res2"))
