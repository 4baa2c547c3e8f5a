"""``mfu.<suffix>``: the model's operations over the traced window (the
configuration's convolutions and matrix products per image, ``counts/``,
times the images the window completed) over the window and the card's peak
for the configuration's math (bf16 989 TFLOP/s; f32 with TF32 off
67 TFLOP/s; ``precision.peak_flops`` of the configuration file), in %."""
from perfbench.counts import model
from perfbench.metrics._common import inputs


def read(run, suffix):
    got = inputs(run, "window_s", "images", "batch")
    if got is None:
        return None
    window_s, images, batch = got
    cfg = run.config["cfg"]
    if suffix == "train":
        bucket = tuple(cfg["TPU"]["TRAIN_BUCKET"])
        per_image = model.step_flops(cfg, bucket, batch) / batch
    else:
        bucket = tuple(cfg["TPU"]["TEST_BUCKET"])
        per_image = model.eval_flops(cfg, bucket, batch) / batch
    peak = float(run.config["precision"]["peak_flops"])
    return 100.0 * per_image * images / (window_s * peak)
