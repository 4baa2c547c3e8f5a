"""The engine slice of the PyTorch port against the JAX package, on the CPU:
``TrainLoader`` (bitwise the JAX loader's batches), ``EventWriter``
(``metrics.json`` lines), ``Checkpointer`` (round trip, ``last_checkpoint``,
weights-only load, the JAX package's weight formats: .npz, d2 .pkl and .pth load,
an Orbax directory raises), ``do_train`` against JAX's
``do_train`` on the same config (``tests/test_e2e.py``'s ``make_cfg`` at a
128 x 160 bucket: the same ``metrics.json`` iterations and keys, checkpoint
iterations and learning rates; a resume that restores step, parameters and
momentum bitwise), and the CLI ``python -m openset_rcnn_tpu_torch.train``
(``--eval-only``, ``--test_iter``, ``--resume``, ``--resume_test``, and the
raises until data-parallel training is ported)."""
import json
import os

import numpy as np
import pytest
import torch

from openset_rcnn_tpu.data import loader as jax_loader_mod
from openset_rcnn_tpu.data.catalog import DatasetCatalog as JaxDatasets, MetadataCatalog as JaxMeta
from openset_rcnn_tpu.data.transforms import DetectionTransform as JaxTransform
from openset_rcnn_tpu.engine import events as jax_events
from openset_rcnn_tpu.engine import optimizer as jax_opt
from openset_rcnn_tpu.engine import train_loop as jax_loop
from openset_rcnn_tpu.utils import torch_weights as jax_weights
from openset_rcnn_tpu_torch import train as cli
from openset_rcnn_tpu_torch.config import get_default_cfg as port_default_cfg
from openset_rcnn_tpu_torch.data import loader as port_loader_mod
from openset_rcnn_tpu_torch.data.catalog import DatasetCatalog as PortDatasets, MetadataCatalog as PortMeta
from openset_rcnn_tpu_torch.data.synthetic import generate_synthetic_dataset
from openset_rcnn_tpu_torch.data.transforms import DetectionTransform as PortTransform
from openset_rcnn_tpu_torch.engine import checkpoint as port_ckpt
from openset_rcnn_tpu_torch.engine import events as port_events
from openset_rcnn_tpu_torch.engine import train_loop as port_loop
from openset_rcnn_tpu_torch.engine.train_state import Trainer
from tests import test_torch_port_weights as port_weights
from tests.port_threads import share_cores  # noqa: F401 (autouse)
from tests.test_e2e import CLASSES, make_cfg
from tests.test_torch_converter import build_torch_dict

TRAIN, TEST = "port_engine_train", "port_engine_test"


def port_cfg(jcfg):
    cfg = port_default_cfg()
    cfg.merge_from_other(jcfg.to_dict())
    return cfg


def register(name, records):
    for datasets, meta in ((JaxDatasets, JaxMeta), (PortDatasets, PortMeta)):
        datasets.remove(name)
        datasets.register(name, lambda r=records: r)
        meta.get(name).update(evaluator_type="voc_records", thing_classes=CLASSES)


# ---------------------------------------------------------------- loader


@pytest.fixture(scope="module")
def loader_records(tmp_path_factory):
    """Landscape and portrait synthetic images, one record without
    annotations and one whose file is missing (the placeholder)."""
    tmp = tmp_path_factory.mktemp("loader")
    land = generate_synthetic_dataset(str(tmp / "land"), num_images=7, image_hw=(240, 320), seed=1)
    port = generate_synthetic_dataset(str(tmp / "port"), num_images=5, image_hw=(320, 240), seed=2)
    for i, r in enumerate(port):
        r["image_id"] = 100 + i
    empty = dict(land[0], image_id=200, annotations=[])
    missing = dict(port[0], image_id=300, file_name=str(tmp / "missing.png"))
    return land + port + [empty, missing]


def transforms(kind):
    args = dict(min_sizes=(96, 128, 160), max_size=256, bucket_hw=(160, 256), max_gt=8, flip=True)
    return (JaxTransform if kind == "jax" else PortTransform)(**args)


def take(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def assert_same_batches(port_batches, jax_batches):
    for (pb, pm), (jb, jm) in zip(port_batches, jax_batches):
        np.testing.assert_array_equal(pb.images.numpy(), np.asarray(jb.images))
        assert pb.images.dtype == torch.uint8
        np.testing.assert_array_equal(pb.image_hw.numpy(), np.asarray(jb.image_hw))
        np.testing.assert_array_equal(pb.gt.boxes.numpy(), np.asarray(jb.gt.boxes))
        np.testing.assert_array_equal(pb.gt.classes.numpy(), np.asarray(jb.gt.classes))
        np.testing.assert_array_equal(pb.gt.valid.numpy(), np.asarray(jb.gt.valid))
        assert (pm.image_ids, pm.input_hw, pm.original_hw, pm.bucket_hw) == \
            (jm.image_ids, jm.input_hw, jm.original_hw, jm.bucket_hw)


def test_train_loader_batches_match_jax_bitwise(loader_records):
    """Eight batches (more than an epoch: the second epoch's permutation,
    both buckets, flips, multi-scale) equal JAX's, pixel for pixel."""
    kw = dict(batch_size=3, seed=5, num_workers=3, filter_empty=False)
    want = take(jax_loader_mod.TrainLoader(loader_records, transforms("jax"), **kw), 8)
    got = take(port_loader_mod.TrainLoader(loader_records, transforms("port"), **kw), 8)
    assert_same_batches(got, want)
    assert {m.bucket_hw for _, m in got} == {(160, 256), (256, 160)}
    ids = [i for _, m in got for i in m.image_ids]
    assert 200 in ids and 300 in ids  # the empty and the unreadable record, unfiltered


def test_train_loader_shards_and_filter_empty(loader_records):
    """Two shards concatenated are the single-process batch; filter_empty
    drops the record without annotations, as JAX's ``_filter_empty``."""
    assert port_loader_mod._filter_empty(loader_records) == jax_loader_mod._filter_empty(loader_records)
    assert len(port_loader_mod._filter_empty(loader_records)) == len(loader_records) - 1
    one = take(port_loader_mod.TrainLoader(loader_records, transforms("port"), batch_size=4, seed=2), 5)
    shards = [take(port_loader_mod.TrainLoader(loader_records, transforms("port"), batch_size=2, seed=2,
                                               shard_id=s, num_shards=2), 5) for s in (0, 1)]
    for i, (batch, meta) in enumerate(one):
        (b0, m0), (b1, m1) = shards[0][i], shards[1][i]
        assert torch.equal(batch.images, torch.cat([b0.images, b1.images]))
        assert torch.equal(batch.gt.boxes, torch.cat([b0.gt.boxes, b1.gt.boxes]))
        assert meta.image_ids == m0.image_ids + m1.image_ids
        assert 200 not in meta.image_ids


def test_train_loader_raises_a_workers_exception(loader_records):
    """A transform that fails (here: a scale beyond the bucket) is raised in
    the consumer."""
    transform = PortTransform(min_sizes=(200,), max_size=400, bucket_hw=(160, 256), max_gt=8, flip=False)
    with pytest.raises(ValueError, match="broadcast"):
        take(port_loader_mod.TrainLoader(loader_records, transform, batch_size=2, num_workers=2), 1)


def test_train_loader_placeholder_matches_jax(loader_records):
    """An unreadable image becomes a black image of its bucket without GT."""
    rec = loader_records[-1]
    want = jax_loader_mod.TrainLoader(loader_records, transforms("jax"), 2)._placeholder(rec)
    got = port_loader_mod.TrainLoader(loader_records, transforms("port"), 2)._placeholder(rec)
    assert got.bucket_hw == want.bucket_hw == (256, 160) and not got.image.any() and not got.gt_valid.any()
    for field in ("image", "boxes", "classes", "gt_valid"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert (got.image_hw, got.original_hw, got.image_id) == (want.image_hw, want.original_hw, want.image_id)


# ---------------------------------------------------------------- events


def test_event_writer_lines_match_jax(tmp_path, monkeypatch):
    """The same writes give the same metrics.json lines (``time`` from the
    second write on, its value from the clock)."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    for mod in (jax_events, port_events):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
    writes = [(1, {"total_loss": np.float32(2.5), "lr": 0.001}), (20, {"total_loss": torch.tensor(1.25)}),
              (20, {"ds/mAP": 3.0, "ds/WI": 0.5}), (21, {"total_loss": 1.0})]
    lines = {}
    for kind, mod in (("jax", jax_events), ("port", port_events)):
        writer = mod.EventWriter(str(tmp_path / kind), flush_period=20)
        for step, scalars in writes:
            writer.write(step, {k: (v.numpy() if kind == "jax" and torch.is_tensor(v) else v)
                                for k, v in scalars.items()})
        writer.close()
        lines[kind] = [json.loads(line) for line in open(tmp_path / kind / "metrics.json")]
    assert lines["port"] == lines["jax"]
    assert [line["iteration"] for line in lines["port"]] == [1, 20, 20, 21]
    assert "time" not in lines["port"][0] and lines["port"][1]["time"] == 0.25


def test_event_writer_without_tensorboardx(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__
    monkeypatch.setattr(builtins, "__import__", lambda name, *a, **k: (
        (_ for _ in ()).throw(ImportError(name)) if name == "tensorboardX" else real(name, *a, **k)))
    writer = port_events.EventWriter(str(tmp_path))
    writer.write(1, {"x": 1.0})
    writer.close()
    assert writer._tb is None and json.loads(open(tmp_path / "metrics.json").read()) == {"iteration": 1, "x": 1.0}


# ---------------------------------------------------------------- checkpoints


def small_cfg(tmp_path):
    cfg = port_cfg(make_cfg(tmp_path))
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0
    return cfg


def test_checkpointer_round_trip_and_weights_only_load(tmp_path):
    cfg = small_cfg(tmp_path)
    a = Trainer(cfg, device="cpu", seed=1)
    a.state.step = 7
    for buf in a.state.optimizer.param_groups[0]["params"][:3]:
        a.state.optimizer.state[buf]["momentum_buffer"] = torch.full_like(buf, 0.5)
    ckpt = port_ckpt.Checkpointer(str(tmp_path / "ck"))
    assert ckpt.latest_path() is None
    path = ckpt.save(a.state, 7)
    assert os.path.basename(path) == "model_0000007.pt" and ckpt.latest_path() == path
    assert open(tmp_path / "ck" / "last_checkpoint").read() == "model_0000007.pt"

    b = Trainer(cfg, device="cpu", seed=2)
    state, resumed = ckpt.resume_or_load(b.state, "", resume=True)
    assert resumed and state.step == 7
    for (n, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(p, q), n
    assert str(a.state.optimizer.state_dict()) == str(b.state.optimizer.state_dict())

    c = Trainer(cfg, device="cpu", seed=3)  # weights only: parameters, not step or momentum
    state, resumed = port_ckpt.Checkpointer(str(tmp_path / "other")).resume_or_load(c.state, path, resume=True)
    assert not resumed and state.step == 0 and not c.state.optimizer.state
    assert all(torch.equal(p, q) for p, q in zip(a.model.state_dict().values(), c.model.state_dict().values()))
    name = next(iter(c.model.state_dict()))
    torch.save({"model": {name: torch.zeros(1)}}, tmp_path / "bad.pt")
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_ckpt.load_weights_file(str(tmp_path / "bad.pt"), c.model)
    torch.save({"model": {"nothing.here": torch.zeros(1)}}, tmp_path / "unknown.pt")
    with pytest.raises(KeyError, match="does not have"):
        port_ckpt.load_weights_file(str(tmp_path / "unknown.pt"), c.model)
    torch.save(c.model.state_dict(), tmp_path / "bare.pt")
    with pytest.raises(ValueError, match="not a port checkpoint"):
        port_ckpt.load_weights_file(str(tmp_path / "bare.pt"), c.model)


@pytest.mark.parametrize("name", ["orbax_dir", "weights.npz", "model_final.pkl", "R-50.pth"])
def test_unported_weight_formats_raise(tmp_path, name):
    """The JAX package's other weight formats through ``load_weights_file``
    (the name predates the converters): an Orbax directory still raises
    ``NotImplementedError``, now with the reason (Orbax imports JAX and
    needs tensorstore) and the .npz route; the JAX package's flat .npz, a d2
    .pkl and a d2 .pth (model, optimizer, scheduler, iteration) load, each
    to JAX's converter followed by ``state_dict_from_jax``, bitwise."""
    path = tmp_path / name
    model = Trainer(small_cfg(tmp_path), device="cpu", seed=1).model
    if name == "orbax_dir":
        path.mkdir()
        with pytest.raises(NotImplementedError, match="Orbax checkpoint directories do not load.*tensorstore.*npz"):
            port_ckpt.load_weights_file(str(path), model)
        return
    template = port_weights.jax_template(make_cfg(tmp_path))
    rng = np.random.RandomState(0)
    if name.endswith(".npz"):
        port_weights.write_npz(port_weights.random_params(template, rng), path)
        want = jax_weights.load_npz_into_params(str(path), template)
    else:
        path = port_weights.write_source(name.split(".")[-1], build_torch_dict(template, rng), tmp_path)
        want = jax_weights.convert_torch_checkpoint(path, template)
    port_ckpt.load_weights_file(str(path), model)
    port_weights.assert_state_equal(model.state_dict(), port_weights.jax_state(want, model))


# ---------------------------------------------------------------- do_train


def train_cfg(tmp_path, out, max_iter=4):
    cfg = make_cfg(tmp_path)
    cfg.OUTPUT_DIR = str(tmp_path / out)
    cfg.DATASETS.TRAIN, cfg.DATASETS.TEST = (TRAIN,), (TEST,)
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.SOLVER.WARMUP_ITERS = 3  # the warm-up ends inside the run
    cfg.TEST.EVAL_PERIOD = 3
    cfg.INPUT.MIN_SIZE_TRAIN = (96, 112)
    cfg.INPUT.MAX_SIZE_TRAIN = 160
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE_TEST = 160
    cfg.TPU.TRAIN_BUCKET, cfg.TPU.TEST_BUCKET = (128, 160), (96, 160)
    cfg.TPU.EVAL_BATCH_SIZE = 2
    cfg.MODEL.RPN.DELTA_BIAS_INIT = 1.0
    return cfg


def metrics(out):
    return [json.loads(line) for line in open(os.path.join(out, "metrics.json"))]


def checkpoints(out):
    return sorted(int(n[6:13]) for n in os.listdir(out) if n.startswith("model_"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("do_train")
    register(TRAIN, generate_synthetic_dataset(str(tmp / "train"), num_images=6, image_hw=(240, 320), seed=0))
    register(TEST, generate_synthetic_dataset(str(tmp / "test"), num_images=2, image_hw=(240, 320), seed=99))
    jcfg = train_cfg(tmp, "jax")
    jax_state = jax_loop.do_train(jcfg)
    pcfg = port_cfg(train_cfg(tmp, "port"))
    port_state = port_loop.do_train(pcfg, device="cpu")
    yield dict(tmp=tmp, jcfg=jcfg, pcfg=pcfg, jax_state=jax_state, port_state=port_state)
    for name in (TRAIN, TEST):
        JaxDatasets.remove(name)
        PortDatasets.remove(name)


def test_do_train_writes_what_jax_writes(trained):
    """metrics.json: the same iterations (1, the eval at 3, MAX_ITER 4) and
    keys per line; the same checkpoints (2 and 4, the final save) and
    marker; the same learning rate at every iteration."""
    want, got = metrics(trained["jcfg"].OUTPUT_DIR), metrics(trained["pcfg"].OUTPUT_DIR)
    assert [line["iteration"] for line in got] == [line["iteration"] for line in want] == [1, 3, 4]
    assert [set(line) for line in got] == [set(line) for line in want]
    assert f"{TEST}/mAP" in got[1] and "total_loss" in got[0] and "time" in got[2]
    assert all(np.isfinite(line["total_loss"]) for line in got if "total_loss" in line)
    for g, w in zip(got, want):
        if "lr" in w:
            assert g["lr"] == w["lr"], (g["iteration"], g["lr"], w["lr"])
    assert checkpoints(trained["pcfg"].OUTPUT_DIR) == checkpoints(trained["jcfg"].OUTPUT_DIR) == [2, 4]
    assert open(os.path.join(trained["pcfg"].OUTPUT_DIR, "last_checkpoint")).read() == "model_0000004.pt"
    _, sched = jax_opt.build_optimizer(trained["jcfg"], trained["jax_state"].params)
    schedule = Trainer(trained["pcfg"], device="cpu").schedule
    assert [schedule(k) for k in range(6)] == [float(sched(k)) for k in range(6)]
    assert trained["port_state"].step == int(trained["jax_state"].step) == 4


def test_do_train_resume_restores_step_parameters_and_momentum(trained):
    """A resumed run restores the final state bitwise and continues its
    metrics at start_iter + 1, as JAX's does (the loader restarts)."""
    state = trained["port_state"]
    fresh = Trainer(trained["pcfg"], device="cpu", seed=9)
    port_ckpt.Checkpointer(trained["pcfg"].OUTPUT_DIR).restore(fresh.state)
    assert fresh.state.step == 4
    for (n, p), q in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(p, q), n
    opt_a, opt_b = state.optimizer.state_dict(), fresh.state.optimizer.state_dict()
    assert opt_a["state"].keys() == opt_b["state"].keys() and len(opt_a["state"]) > 0
    for k in opt_a["state"]:
        assert torch.equal(opt_a["state"][k]["momentum_buffer"], opt_b["state"][k]["momentum_buffer"])

    cfg = trained["pcfg"].clone()
    cfg.SOLVER.MAX_ITER = 6
    resumed = port_loop.do_train(cfg, resume=True, device="cpu")
    assert resumed.step == 6
    assert [line["iteration"] for line in metrics(cfg.OUTPUT_DIR)] == [1, 3, 4, 5, 6]
    assert checkpoints(cfg.OUTPUT_DIR) == [2, 4, 6]


def test_do_train_raises_without_one_device(trained):
    cfg = trained["pcfg"].clone()
    cfg.TPU.MESH_DATA = 2
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        port_loop.do_train(cfg, device="cpu")
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL = 1, 2
    with pytest.raises(NotImplementedError, match="DDP"):
        port_loop.do_train(cfg, device="cpu")


# ---------------------------------------------------------------- CLI


def run_cli(argv):
    return cli.main(cli.get_parser().parse_args(argv), device="cpu")


def test_cli_eval_only_test_iter_and_resume_test(trained):
    """--eval-only evaluates the latest checkpoint (--resume) or a given
    iteration (--test_iter), as do_test on its weights; --resume_test
    re-scores the saved detections to the same metrics."""
    tmp = trained["tmp"]
    cfg = trained["pcfg"].clone()
    cfg.OUTPUT_DIR = str(tmp / "cli")
    yaml = tmp / "cli.yaml"
    yaml.write_text(cfg.dump())
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    for step in (2, 4):
        os.link(os.path.join(trained["pcfg"].OUTPUT_DIR, f"model_{step:07d}.pt"),
                os.path.join(cfg.OUTPUT_DIR, f"model_{step:07d}.pt"))
    with open(os.path.join(cfg.OUTPUT_DIR, "last_checkpoint"), "w") as f:
        f.write("model_0000004.pt")
    latest = run_cli(["--config-file", str(yaml), "--eval-only", "--resume"])
    assert set(latest) == {TEST} and np.isfinite(latest[TEST]["WI"])
    want = port_loop.do_test(cfg, trained["port_state"].model.state_dict(), device="cpu")
    assert latest == want
    assert run_cli(["--config-file", str(yaml), "--resume_test"]) == latest
    at2 = run_cli(["--config-file", str(yaml), "--eval-only", "--test_iter", "2"])
    ckpt = torch.load(os.path.join(cfg.OUTPUT_DIR, "model_0000002.pt"), weights_only=True)
    assert at2 == port_loop.do_test(cfg, ckpt["model"], device="cpu")
    assert os.path.exists(os.path.join(cfg.OUTPUT_DIR, "config.yaml"))
    assert os.path.getsize(os.path.join(cfg.OUTPUT_DIR, "log.txt")) > 0


def test_cli_trains_and_resumes(trained):
    tmp = trained["tmp"]
    cfg = trained["pcfg"].clone()
    cfg.OUTPUT_DIR = str(tmp / "cli_train")
    cfg.TEST.EVAL_PERIOD = 0
    yaml = tmp / "cli_train.yaml"
    yaml.write_text(cfg.dump())
    state = run_cli(["--config-file", str(yaml), "SOLVER.MAX_ITER", "2"])
    assert state.step == 2 and checkpoints(cfg.OUTPUT_DIR) == [2]
    state = run_cli(["--config-file", str(yaml), "--resume", "SOLVER.MAX_ITER", "3"])
    assert state.step == 3 and checkpoints(cfg.OUTPUT_DIR) == [2, 3]
    assert [line["iteration"] for line in metrics(cfg.OUTPUT_DIR)] == [1, 2, 3]


@pytest.mark.parametrize("argv", [["--num-gpus", "2"], ["--num-machines", "2"], ["--dist-url", "tcp://localhost:1"],
                                  ["TPU.MESH_DATA", "2"]])
def test_cli_raises_until_data_parallel_training(trained, argv):
    tmp = trained["tmp"]
    cfg = trained["pcfg"].clone()
    cfg.OUTPUT_DIR = str(tmp / "cli_ddp")
    yaml = tmp / "cli_ddp.yaml"
    yaml.write_text(cfg.dump())
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        run_cli(["--config-file", str(yaml), *argv])
    assert not os.path.exists(os.path.join(cfg.OUTPUT_DIR, "last_checkpoint"))
