"""``roi_heads_ms.<suffix>``: device ms of a serving batch from the RPN's
end ("rpn") to the cascade's end ("cascade"): RoIAlign (K1), the four heads,
the raw detections and the fused cascade (K4), a mean over the traced
window. CUDA events at ``Predictor``'s ``mark`` callbacks."""
from perfbench.metrics._common import inputs, mean


def read(run, suffix):
    got = inputs(run, "marks")
    return None if got is None else mean(got[0].between_ms("rpn", "cascade"))
