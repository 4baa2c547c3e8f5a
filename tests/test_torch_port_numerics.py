"""The port's entry points carry their own numerics, on the CPU: inside
``Predictor`` and ``Trainer.step`` TF32 and bf16 reduced-precision
reductions are off (and the train step picks cuDNN's deterministic
algorithms without autotuning), whatever the caller set, and the caller's
flags come back afterwards; two train steps from one state on one batch give
bitwise equal parameters."""
import copy

import numpy as np
import pytest
import torch

from openset_rcnn_tpu_torch.config import get_default_cfg
from openset_rcnn_tpu_torch.device import entry_numerics, numerics_flags
from openset_rcnn_tpu_torch.engine.train_state import Trainer
from openset_rcnn_tpu_torch.evaluation.inference import Predictor
from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch
from tests.test_torch_port_train_step import CONFIG, IMAGE_HW, make_batch

SERVE = {"cudnn.allow_tf32": False, "matmul.allow_tf32": False,
         "matmul.allow_bf16_reduced_precision_reduction": False}
TRAIN = {**SERVE, "cudnn.deterministic": True, "cudnn.benchmark": False}
# the opposite of every flag the entry points set: what a caller may have set
CALLER = {"cudnn.allow_tf32": True, "matmul.allow_tf32": True,
          "matmul.allow_bf16_reduced_precision_reduction": True,
          "cudnn.deterministic": False, "cudnn.benchmark": True}


def set_flags(flags):
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    cudnn.allow_tf32 = flags["cudnn.allow_tf32"]
    matmul.allow_tf32 = flags["matmul.allow_tf32"]
    matmul.allow_bf16_reduced_precision_reduction = flags["matmul.allow_bf16_reduced_precision_reduction"]
    cudnn.deterministic = flags["cudnn.deterministic"]
    cudnn.benchmark = flags["cudnn.benchmark"]


@pytest.fixture
def caller_flags():
    saved = numerics_flags()
    set_flags(CALLER)
    yield
    set_flags(saved)


def load_cfg():
    cfg = get_default_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0  # proposals of positive size from a random init
    cfg.SOLVER.WARMUP_ITERS = 0
    return cfg


def host_batch(cfg):
    images, boxes, classes, valid = make_batch(np.random.RandomState(1), cfg.MODEL.PIXEL_MEAN)
    return ImageBatch(torch.from_numpy(images), torch.from_numpy(IMAGE_HW),
                      GroundTruth(torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid)))


def observer():
    seen = []
    return seen, lambda stage: seen.append((stage, numerics_flags()))


def test_entry_numerics_sets_and_restores(caller_flags):
    for deterministic, want in ((False, {**SERVE, "cudnn.deterministic": False, "cudnn.benchmark": True}),
                                (True, TRAIN)):
        with entry_numerics(deterministic):
            assert numerics_flags() == want
        assert numerics_flags() == CALLER
    with pytest.raises(ValueError):  # restored on the way out of an error too
        with entry_numerics(True):
            raise ValueError
    assert numerics_flags() == CALLER


def test_predictor_runs_with_its_own_numerics(caller_flags):
    cfg = load_cfg()
    batch = host_batch(cfg)
    predictor = Predictor(cfg, device="cpu")
    seen, mark = observer()
    predictor(batch.images, batch.image_hw, mark=mark)
    assert [s for s, _ in seen] == ["backbone", "rpn", "roi_align", "heads", "cascade"]
    for stage, flags in seen:
        assert {k: flags[k] for k in SERVE} == SERVE, stage
    assert numerics_flags() == CALLER


def test_trainer_step_runs_deterministic_with_its_own_numerics(caller_flags):
    cfg = load_cfg()
    trainer = Trainer(cfg, device="cpu", seed=3)
    seen, mark = observer()
    trainer.step(host_batch(cfg), mark=mark)
    assert [s for s, _ in seen] == ["backbone", "rpn", "sampling", "roi_align", "heads", "backward", "optimizer"]
    for stage, flags in seen:
        assert flags == TRAIN, stage
    assert numerics_flags() == CALLER


def test_two_train_steps_from_one_state_are_bitwise_equal():
    """The structure of the card's gate (chip_smoke's ``repeat_step``): one
    state, one batch, two steps, the same parameters bit for bit."""
    cfg = load_cfg()
    trainer, batch = Trainer(cfg, device="cpu", seed=3), host_batch(cfg)
    trainer.step(batch)  # momentum in the state
    state = trainer.state
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    momentum = copy.deepcopy(state.optimizer.state_dict())
    step = state.step
    first_metrics = trainer.step(batch)
    first = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state.model.load_state_dict(params)
    state.optimizer.load_state_dict(momentum)
    state.step = step
    second_metrics = trainer.step(batch)
    moved = [n for n, p in state.model.named_parameters() if p.requires_grad and not torch.equal(p, params[n])]
    assert moved, "the step moved no parameter"
    for n, p in state.model.named_parameters():
        assert torch.equal(p, first[n]), n
    for k, v in first_metrics.items():
        assert torch.equal(v, second_metrics[k]), k
