"""``mvit_res3_ms.<suffix>``: device ms of a serving batch from the
program's "backbone.res2" mark to its "backbone.res3" mark: MViT's stage 2
(the query-pooling transition block, four windowed blocks and the global
block 7 with its resized relative-position tables) and its output norm, a
mean over the traced window. CUDA events at ``Predictor``'s ``mark``
callbacks; None where the trunk gives no such marks."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "marks")
    return None if got is None else mean(got[0].between_ms("backbone.res2", "backbone.res3"))
