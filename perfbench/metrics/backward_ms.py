"""``backward_ms.<suffix>``: device ms of a training step's backward, from
the last forward mark ("heads") to "backward", a mean over the traced
window. CUDA events at ``Trainer.step``'s ``mark`` callbacks."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "marks")
    return None if got is None else mean(got[0].between_ms("heads", "backward"))
