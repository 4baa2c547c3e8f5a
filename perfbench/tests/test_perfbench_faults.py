"""A run with its timed path broken underneath comes out not correct: the
cells' entry loops driven on the CPU at a small size (past the harness's
look for a card), once for each fault the cell can have. Training: a step
that leaves its state unchanged; half of the batch left out, the losses the
mean over the rest. Evaluation: half of the batch left out; an answer
altered where it is produced; every box moved where it is produced (a
wrong rescale), on both configurations. Frames (batch 1): an answer
altered. The
exchange between cards does not exist on one card. A number the fault fails
has to lie beyond its limit and three times beyond the sound run's
reading."""
import pytest
import torch

from perfbench.tests.small import run_small, small_cell


def _failed(broken, sound):
    """The compared numbers that the broken run fails and that lie well
    beyond the sound run's reading of them."""
    base = {c.name: c.value for c in sound.checks}
    out = []
    for c in broken.checks:
        beyond = c.value < base[c.name] / 3 if c.at_least else c.value > 3 * base[c.name]
        if not c.ok and beyond:
            out.append(c.name)
    return out


def _fails(broken, sound):
    assert broken.line["correct"] is False
    assert _failed(broken, sound), ([(c.name, c.value, c.limit) for c in broken.checks],
                                    [(c.name, c.value) for c in sound.checks])


@pytest.fixture(scope="module")
def sound_train():
    return run_small(small_cell("r50_bf16.train"))


@pytest.fixture(scope="module")
def sound_eval():
    return run_small(small_cell("r50_bf16.eval"))


@pytest.fixture(scope="module")
def sound_vitdet():
    return run_small(small_cell("vitdet_b.eval"))


def test_train_state_left_unchanged(monkeypatch, sound_train):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    _fails(run_small(small_cell("r50_bf16.train")), sound_train)


def test_train_half_batch_left_out(monkeypatch, sound_train):
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch

    step = Trainer.step

    def half(self, batch, uniforms=None, mark=None):
        n = batch.images.shape[0] // 2
        batch = ImageBatch(batch.images[:n], batch.image_hw[:n],
                           GroundTruth(batch.gt.boxes[:n], batch.gt.classes[:n], batch.gt.valid[:n]))
        return step(self, batch, {k: v[:n] for k, v in uniforms.items()}, mark)

    monkeypatch.setattr(Trainer, "step", half)
    _fails(run_small(small_cell("r50_bf16.train")), sound_train)


def test_eval_half_batch_left_out(monkeypatch, sound_eval):
    from openset_rcnn_tpu_torch.evaluation.inference import Predictor

    call = Predictor.__call__

    def half(self, images, image_hw, mark=None):
        out = call(self, images, image_hw, mark)
        valid = out.valid.clone()
        valid[images.shape[0] // 2:] = False
        return out._replace(valid=valid)

    monkeypatch.setattr(Predictor, "__call__", half)
    _fails(run_small(small_cell("r50_bf16.eval")), sound_eval)


def _alter_top(monkeypatch, module):
    """Every answer's score raised by 0.1 where the host finalize produces
    it (beyond the 0.05 within which one detection's scores agree)."""
    finalize = module.finalize_serve_image

    def altered(*args, **kwargs):
        out = finalize(*args, **kwargs)
        out.scores[:] = out.scores + 0.1
        return out

    monkeypatch.setattr(module, "finalize_serve_image", altered)


def test_eval_answer_altered(monkeypatch, sound_eval):
    from openset_rcnn_tpu_torch.evaluation import testing

    _alter_top(monkeypatch, testing)
    _fails(run_small(small_cell("r50_bf16.eval")), sound_eval)


def test_frame_answer_altered(monkeypatch):
    from openset_rcnn_tpu_torch.evaluation import postprocess

    sound = run_small(small_cell("r50_bf16.frame1"))
    _alter_top(monkeypatch, postprocess)
    _fails(run_small(small_cell("r50_bf16.frame1")), sound)


def test_eval_boxes_moved(monkeypatch, sound_eval, sound_vitdet):
    """Every box scaled by 1.05 about the origin where the host finalize
    produces it, as a wrong rescale would: no box keeps an IoU of 0.98."""
    from openset_rcnn_tpu_torch.evaluation import testing

    finalize = testing.finalize_serve_image

    def moved(*args, **kwargs):
        out = finalize(*args, **kwargs)
        out.boxes[:] = out.boxes * 1.05
        return out

    monkeypatch.setattr(testing, "finalize_serve_image", moved)
    for name, sound in (("r50_bf16.eval", sound_eval), ("vitdet_b.eval", sound_vitdet)):
        _fails(run_small(small_cell(name)), sound)
