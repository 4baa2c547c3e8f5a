"""``eva_trunk_ms.<suffix>``: device ms of a serving batch from its start to
the program's "backbone.trunk" mark: the preprocess and EVA-02's trunk
(patch embedding, positions, the 24 blocks with their RoPE, SwiGLU and
windowed or global attention, the final norm), a mean over the traced
window. CUDA events at ``Predictor``'s ``mark`` callbacks; None where the
trunk gives no such mark."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "marks")
    return None if got is None else mean(got[0].between_ms("begin", "backbone.trunk"))
