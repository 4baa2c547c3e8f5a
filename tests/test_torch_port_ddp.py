"""Multi-process training and evaluation of the PyTorch port, on the CPU.

Gloo processes started by ``parallel.launch`` (rendezvous through a file in
the test's directory, so parallel test workers never race for a port) run
the rank bodies of ``tests/port_ddp_worker.py``, at
``test_torch_port_engine.train_cfg``'s scale (the R50-FPN at a 128 x 160
bucket, norm clipping at 1.0), global batch 2, 4 iterations:

- data parallelism (``TPU.MESH_DATA 2``) against the one-process run: the
  sampling draws exactly its rows, iteration 1's metrics within 1e-5
  relative (counts exact), step 1's reduced gradients per tensor within
  ``GRAD_TOL`` (with a control that must fail: the backward without its
  factor W), the parameters after 4 steps within rtol 2e-3 /
  atol 2e-4 (the standard of ``tests/test_engine_mesh.py:50-52``),
  ``metrics.json`` and checkpoints from rank 0 only and loadable by one
  process; the lines JAX's single-device ``do_train`` writes
  (iterations, keys, learning rates, checkpoints); a step repeated from one
  state bitwise on every rank (also under model parallelism);
- model parallelism (``TPU.MESH_MODEL 2``): the sharded seeded init gathered
  bitwise the one-process init, clipping by the global norm over sharded
  gradients, step 1's gathered gradients (with a control that must fail:
  fc1's input gradient left unsummed over the model group), the bf16 box
  head's sharded forward, iteration 1's losses and the gathered checkpoint;
- ``do_test`` over two processes (fused and ``proposals``) equal to one
  process, the VOC evaluator's merge of two processes' detections on
  metrics that are not 0, ``gather_object``'s rank order, ``reduce_dict``, and a layout
  that does not fit the group raising;
- the CLI's ``--num-gpus 2`` on the CPU, trained and resumed (two
  processes resuming from a checkpoint);
- without processes: a batch split in two halves whose losses, scalars and
  gradients, with ``global_sum`` the sum over both halves, add up to the
  whole batch's (the prototype term counted once).
"""
import os
import shutil

import numpy as np
import pytest
import torch

from openset_rcnn_tpu.engine import train_loop as jax_loop
from openset_rcnn_tpu_torch import train as cli
from openset_rcnn_tpu_torch.data.catalog import DatasetCatalog as PortDatasets
from openset_rcnn_tpu_torch.data.synthetic import generate_synthetic_dataset
from openset_rcnn_tpu_torch.engine import train_loop as port_loop
from openset_rcnn_tpu_torch.engine import train_state
from openset_rcnn_tpu_torch.engine.checkpoint import Checkpointer
from openset_rcnn_tpu_torch.engine.train_state import Trainer
from openset_rcnn_tpu_torch.models import detector as port_det
from openset_rcnn_tpu_torch.ops.losses import LocalSum
from openset_rcnn_tpu_torch.parallel import launch
from openset_rcnn_tpu_torch.parallel.mesh import MODEL_SHARDED, SINGLE
from openset_rcnn_tpu_torch.structures import GroundTruth, ImageBatch
from tests import port_ddp_worker as worker
from tests.port_threads import share_cores  # noqa: F401 (autouse)
from tests.test_e2e import CLASSES
from tests.test_torch_port_engine import checkpoints, metrics, port_cfg, register, train_cfg
from tests.test_torch_port_train_step import CONFIG, IMAGE_HW, make_batch

TRAIN, TEST = "port_ddp_train", "port_ddp_test"
COUNTS = port_det.COUNT_STATS
METRIC_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)
# step 1's gradients, of each tensor's largest one-process gradient: data 2
# measured 1.6e-3 (box_head.fc1: each rank's forward runs at batch 1, one
# process's at 2), model 2 measured 2.0e-5; the controls measured 0.50 (no
# factor W) and 0.98 (fc1's input gradient unsummed)
GRAD_TOL = {"dp": 5e-3, "tp": 1e-4}
CONTROL_MIN = 0.25


def cfg_for(tmp, out, **tpu):
    cfg = port_cfg(train_cfg(tmp, out))
    cfg.DATASETS.TRAIN, cfg.DATASETS.TEST = (TRAIN,), (TEST,)
    cfg.SOLVER.CHECKPOINT_PERIOD = 4  # one checkpoint a run (~320 MB each)
    for key, value in tpu.items():
        setattr(cfg.TPU, key, value)
    return cfg


def write_cfg(cfg, path):
    path.write_text(cfg.dump())
    return str(path)


def run_ranks(fn, tmp, name, *args):
    return launch(fn, 2, dist_url=f"file://{tmp / ('rendezvous_' + name)}", args=args, device_type="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    train = generate_synthetic_dataset(str(tmp / "train"), num_images=6, image_hw=(240, 320), seed=0)
    test = generate_synthetic_dataset(str(tmp / "test"), num_images=2, image_hw=(240, 320), seed=99)
    register(TRAIN, train)
    register(TEST, test)
    meta = dict(evaluator_type="voc_records", thing_classes=CLASSES)
    datasets = {TRAIN: (train, meta), TEST: (test, meta)}

    jcfg = train_cfg(tmp, "jax")
    jcfg.DATASETS.TRAIN, jcfg.DATASETS.TEST = (TRAIN,), (TEST,)
    jcfg.SOLVER.CHECKPOINT_PERIOD = 4
    jax_loop.do_train(jcfg)

    one = cfg_for(tmp, "one")
    draws = {}
    losses = train_state.training_losses_and_stats

    def recording(*args, uniforms=None, **kwargs):
        draws.setdefault("one", {k: v.clone() for k, v in uniforms.items()})
        return losses(*args, uniforms=uniforms, **kwargs)

    train_state.training_losses_and_stats = recording
    try:
        port_loop.do_train(one, device="cpu")
    finally:
        train_state.training_losses_and_stats = losses

    dp = cfg_for(tmp, "dp", MESH_DATA=2)
    dp_run = run_ranks(worker.data_parallel, tmp, "dp", write_cfg(dp, tmp / "dp.yaml"), datasets, str(tmp))
    tp = cfg_for(tmp, "tp", MESH_MODEL=2)
    tp_run = run_ranks(worker.model_parallel, tmp, "tp", write_cfg(tp, tmp / "tp.yaml"), datasets, str(tmp))
    one_grads = worker.step_from_state(Trainer(one, "cpu", seed=0), worker.first_batch(one, SINGLE), SINGLE)[1]
    yield dict(tmp=tmp, jcfg=jcfg, one=one, dp=dp, tp=tp, dp_run=dp_run, tp_run=tp_run, datasets=datasets,
               draws=[torch.load(tmp / f"draws_rank{r}.pt") for r in (0, 1)], one_draws=draws["one"],
               one_grads=one_grads)
    for name in (TRAIN, TEST):
        PortDatasets.remove(name)
    shutil.rmtree(tmp, ignore_errors=True)  # ~2 GB of checkpoints


def assert_params_close(got, want):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name, **PARAM_TOL)


def assert_first_metrics_match(got, want):
    """Iteration 1's metrics: counts exactly, the rest within 1e-5 relative."""
    assert got["iteration"] == want["iteration"] == 1 and set(got) == set(want)
    for key in want:
        if key in COUNTS or key in ("iteration", "lr"):
            assert got[key] == want[key], (key, got[key], want[key])
        elif key != "time":
            np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL, err_msg=key)


def weights(out, step):
    return torch.load(os.path.join(out, f"model_{step:07d}.pt"), weights_only=True)


def test_data_parallel_draws_are_the_one_process_rows(runs):
    """Each rank's sampling draws are exactly its images' rows of the
    one-process step's draws (global batch 2: one image a rank)."""
    want = runs["one_draws"]
    assert set(want) == {"rpn", "roi"}
    for r, got in enumerate(runs["draws"]):
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key][r:r + 1]), (r, key)


def test_data_parallel_metrics_and_parameters_match_one_process(runs):
    one, dp = runs["one"].OUTPUT_DIR, runs["dp"].OUTPUT_DIR
    want, got = metrics(one), metrics(dp)
    assert [line["iteration"] for line in got] == [line["iteration"] for line in want] == [1, 3, 4]
    assert_first_metrics_match(got[0], want[0])
    assert_params_close(weights(dp, 4)["model"], weights(one, 4)["model"])


def gradient_deviations(got, want):
    """{name: max |got - want| / max |want|} over the trainable tensors."""
    assert got.keys() == want.keys()
    return {n: ((got[n] - w).abs().max() / w.abs().max().clamp(min=1e-30)).item() for n, w in want.items()}


@pytest.mark.parametrize("run", ["dp", "tp"])
def test_first_step_gradients_match_one_process(runs, run):
    """Step 1's gradients as the optimizer receives them (after DDP's
    reduction, the box head's shards gathered, before clipping) against one
    process's on the same global batch, each tensor within GRAD_TOL of its
    largest one-process gradient (the parameters after 4 steps cannot show
    a wrong reduction: clipping and the warm-up keep the update small). Controls that must fail the same check:
    under data parallelism the backward without its factor of W (DDP's mean
    is linear, so that run's gradients are these over W); under model
    parallelism the step with fc1's input gradient left unsummed over the
    model group (run by the ranks)."""
    want = runs["one_grads"]
    got = torch.load(runs["tmp"] / f"grads_{run}.pt")
    deviations = gradient_deviations(got, want)
    worst = max(deviations, key=deviations.get)
    assert deviations[worst] <= GRAD_TOL[run], (worst, deviations[worst])
    if run == "dp":
        control = {n: g / 2 for n, g in got.items()}
    else:
        control = torch.load(runs["tmp"] / "grads_tp_unsummed.pt")
    assert max(gradient_deviations(control, want).values()) > CONTROL_MIN


@pytest.mark.parametrize("run", ["dp_run", "tp_run"])
def test_layout_step_repeats_bitwise(runs, run):
    """On every rank, two steps from one state on one batch give bitwise
    equal parameters, as one process's do (test_torch_port_numerics.py)."""
    assert runs[run]["repeats"] == [True, True]


def test_data_parallel_writes_from_rank_0_in_the_one_process_format(runs):
    """One metrics.json line an iteration, the one-process checkpoints, and
    a checkpoint that one process loads (test_cli_num_gpus_2_trains_and_resumes
    resumes two processes)."""
    dp = runs["dp"]
    assert runs["dp_run"]["step"] == 4
    assert checkpoints(dp.OUTPUT_DIR) == checkpoints(runs["one"].OUTPUT_DIR) == [4]
    assert not [n for n in os.listdir(dp.OUTPUT_DIR) if n.endswith(".tmp")]
    ckpt, want = weights(dp.OUTPUT_DIR, 4), weights(runs["one"].OUTPUT_DIR, 4)
    assert ckpt["step"] == 4 and ckpt["optimizer"]["state"].keys() == want["optimizer"]["state"].keys()
    single = Trainer(runs["one"], device="cpu", seed=5)
    Checkpointer(dp.OUTPUT_DIR).restore(single.state)
    assert single.state.step == 4
    for name, value in ckpt["model"].items():
        assert torch.equal(single.model.state_dict()[name], value), name


def test_data_parallel_writes_what_jax_writes(runs):
    """The two-process run's metrics.json against JAX's single-device
    do_train on the same data, as test_do_train_writes_what_jax_writes holds
    the one-process run: iterations, keys, learning rates, checkpoints."""
    want, got = metrics(runs["jcfg"].OUTPUT_DIR), metrics(runs["dp"].OUTPUT_DIR)
    assert [line["iteration"] for line in got] == [line["iteration"] for line in want] == [1, 3, 4]
    assert [set(line) for line in got] == [set(line) for line in want]
    for g, w in zip(got, want):
        if "lr" in w:
            assert g["lr"] == w["lr"]
    assert checkpoints(runs["jcfg"].OUTPUT_DIR) == checkpoints(runs["dp"].OUTPUT_DIR) == [4]


def test_model_parallel_init_and_clipping_match_one_process(runs):
    tp = runs["tp_run"]
    one = Trainer(runs["one"], device="cpu", seed=0).model.state_dict()
    assert tp["init"].keys() == one.keys()
    for name in one:
        assert torch.equal(tp["init"][name], one[name]), name
    assert tp["shards"]["box_head.fc1.weight"] == (512, 256 * 49)
    assert tp["shards"]["box_head.fc1.bias"] == (512,)
    assert tp["shards"]["box_head.fc2.weight"] == (1024, 512)
    assert tp["shards"]["box_head.fc2.bias"] == (1024,)

    from openset_rcnn_tpu_torch.engine.optimizer import clip_gradients

    names = list(tp["whole_grads"])
    params = [torch.nn.Parameter(torch.zeros_like(tp["whole_grads"][n])) for n in names]
    for p, name in zip(params, names):
        p.grad = tp["whole_grads"][name].clone()
    clip_gradients(params, "norm", 1.0)
    want = dict(zip(names, (p.grad for p in params)))
    assert any(not torch.equal(want[n], tp["whole_grads"][n]) for n in names)  # the norm exceeded 1.0
    for name, got in tp["clipped"].items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-9, err_msg=name)


def test_model_parallel_bf16_head(runs):
    """The sharded bf16 box head sums its partial outputs in f32 and rounds
    once: within one bf16 step of the whole head's output."""
    whole, sharded = (t.detach() for t in runs["tp_run"]["bf16"])
    scale = whole.abs().max().item()
    np.testing.assert_allclose(sharded.numpy(), whole.numpy(), atol=scale * 2 ** -8)


def test_model_parallel_training_matches_one_process(runs):
    tp = runs["tp"].OUTPUT_DIR
    assert runs["tp_run"]["step"] == 4 and checkpoints(tp) == [4]
    assert_first_metrics_match(metrics(tp)[0], metrics(runs["one"].OUTPUT_DIR)[0])
    got, want = weights(tp, 4), weights(runs["one"].OUTPUT_DIR, 4)
    assert {k: v.shape for k, v in got["model"].items()} == {k: v.shape for k, v in want["model"].items()}
    assert set(MODEL_SHARDED) <= set(got["model"])
    assert_params_close(got["model"], want["model"])
    momentum = {k: v["momentum_buffer"].shape for k, v in got["optimizer"]["state"].items()}
    assert momentum == {k: v["momentum_buffer"].shape for k, v in want["optimizer"]["state"].items()}


def assert_same_results(got, want):
    """Equal metric dicts, a NaN (a size bin without boxes) equal to a NaN."""
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for key, value in want[name].items():
            assert got[name][key] == value or (np.isnan(got[name][key]) and np.isnan(value)), (name, key)


def test_two_process_do_test_equals_one_process(runs):
    dp_run, dp = runs["dp_run"], runs["dp"].clone()
    dp.OUTPUT_DIR = str(runs["tmp"] / "eval_one")
    state = weights(runs["dp"].OUTPUT_DIR, 4)["model"]
    assert_same_results(dp_run["fused"], port_loop.do_test(dp, state, device="cpu"))
    assert_same_results(dp_run["proposals"], port_loop.do_test(dp, state, eval_type="proposals", device="cpu"))
    assert np.isfinite(dp_run["fused"][TEST]["WI"])
    assert dp_run["gathered"] == [("rank", 0), ("rank", 1)]
    assert dp_run["reduced"] == {"one": 1.0, "rank": 0.5}
    assert "--num-gpus" in dp_run["mismatch"]


def test_evaluator_merges_detections_across_processes(runs):
    """The open-set VOC evaluator of two processes, each holding half the
    images' detections, gives one process's metrics, which are not 0 (the
    do_test runs above score 0 on weights trained 4 steps)."""
    want = worker.voc_merge()
    assert runs["dp_run"]["voc"] == want
    assert all(want[k] > 0 for k in ("mAP", "WI", "AOSE", "AP@K", "AP@U")), want


def test_cli_num_gpus_2_trains_and_resumes(runs, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", str(worker.THREADS))  # the spawned processes' torch threads
    tmp = runs["tmp"]
    cfg = cfg_for(tmp, "cli")
    cfg.TEST.EVAL_PERIOD = 0
    yaml = write_cfg(cfg, tmp / "cli.yaml")
    flags = ["--config-file", yaml, "--num-gpus", "2"]
    run = [*flags, "--dist-url", f"file://{tmp / 'rendezvous_cli'}", "SOLVER.MAX_ITER", "2"]
    assert cli.main(cli.get_parser().parse_args(run), device="cpu") == 2
    assert checkpoints(cfg.OUTPUT_DIR) == [2]
    resume = [*flags, "--resume", "--dist-url", f"file://{tmp / 'rendezvous_cli_resume'}", "SOLVER.MAX_ITER", "3"]
    assert cli.main(cli.get_parser().parse_args(resume), device="cpu") == 3
    assert checkpoints(cfg.OUTPUT_DIR) == [2, 3]
    assert [line["iteration"] for line in metrics(cfg.OUTPUT_DIR)] == [1, 2, 3]
    assert os.path.exists(os.path.join(cfg.OUTPUT_DIR, "log.txt.rank1"))
    assert "MESH_DATA: 2" in open(os.path.join(cfg.OUTPUT_DIR, "config.yaml")).read()  # --num-gpus 2


class HalfSum(LocalSum):
    """``global_sum`` of one half of a batch split in two: its values plus
    the other half's, which a first pass over that half recorded in call
    order."""

    size = 2

    def __init__(self, other=None):
        self.other, self.seen = list(other or []), []

    def __call__(self, x):
        self.seen.append(x.detach().clone())
        return x + self.other[len(self.seen) - 1] if self.other else x


class HalfSumOfOne(HalfSum):
    """The same sums over a data group that claims one rank: each half then
    adds the whole prototype term (the trap)."""

    size = 1


HALF_LOSS_RTOL = 1e-4  # measured 1.9e-5: each half's forward runs at batch 1, the whole's at 2
HALF_GRAD_TOL = 2e-3   # of each tensor's largest gradient; measured 8.7e-4 (the trunk)


def test_half_batch_losses_and_gradients_add_up_to_the_whole_batch():
    """Two halves of a batch, each with ``global_sum`` summing over both,
    give losses and gradients whose sums are the whole batch's, and the
    whole batch's scalars exactly; counting the prototype term in each half
    moves ``loss_dml`` far beyond the tolerance."""
    from openset_rcnn_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(str(CONFIG))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0
    trainer = Trainer(cfg, "cpu", seed=0)
    model, spec = trainer.model, trainer.spec
    images, boxes, classes, valid = (torch.from_numpy(a) for a in make_batch(np.random.RandomState(0),
                                                                               cfg.MODEL.PIXEL_MEAN))
    batch = ImageBatch(images, torch.from_numpy(IMAGE_HW), GroundTruth(boxes, classes, valid))
    anchors, level_sizes = trainer.anchors(tuple(images.shape[1:3]))
    draws = trainer.sampling_draws(batch, anchors.shape[0], level_sizes, train_state.step_generator(0, 0, "cpu"))

    def run(rows, global_sum):
        model.zero_grad(set_to_none=True)
        part = ImageBatch(images[rows], batch.image_hw[rows], GroundTruth(boxes[rows], classes[rows], valid[rows]))
        losses, stats = port_det.training_losses_and_stats(
            model, part, spec, anchors, level_sizes, uniforms={k: v[rows] for k, v in draws.items()},
            global_sum=global_sum)
        sum(losses.values()).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        return losses, stats, grads

    def halves(hook):
        first = [hook(), hook()]
        for i in range(2):
            run(slice(i, i + 1), first[i])
        return [run(slice(i, i + 1), hook(first[1 - i].seen)) for i in range(2)]

    whole = run(slice(0, 2), LocalSum())
    half = halves(HalfSum)
    for key, value in whole[0].items():
        np.testing.assert_allclose((half[0][0][key] + half[1][0][key]).item(), value.item(), rtol=HALF_LOSS_RTOL,
                                   err_msg=key)
    for key, value in whole[1].items():
        assert half[0][1][key].item() == half[1][1][key].item() == value.item(), key
    assert "pln.representatives" in whole[2]
    for name, g in whole[2].items():
        got = half[0][2][name] + half[1][2][name]
        assert (got - g).abs().max().item() <= HALF_GRAD_TOL * g.abs().max().item(), name
    twice = halves(HalfSumOfOne)
    dml = whole[0]["loss_dml"].item()
    assert abs(twice[0][0]["loss_dml"].item() + twice[1][0]["loss_dml"].item() - dml) > 100 * HALF_LOSS_RTOL * dml
