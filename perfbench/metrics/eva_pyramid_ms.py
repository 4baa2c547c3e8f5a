"""``eva_pyramid_ms.<suffix>``: device ms of a serving batch from the
program's "backbone.trunk" mark to its "backbone" mark: EVA-02's simple
pyramid at width 1024 (two deconvolutions, the max-pool, four 1x1 and 3x3
projections with their norms), a mean over the traced window. CUDA events
at ``Predictor``'s ``mark`` callbacks; None where the trunk gives no such
mark."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "marks")
    return None if got is None else mean(got[0].between_ms("backbone.trunk", "backbone"))
