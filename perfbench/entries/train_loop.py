"""The training window: ``Trainer.step`` fed by ``device_prefetch`` over a
``TrainLoader``, as ``do_train``'s loop drives it, the step's metrics read
every 20 steps and never a synchronise per step.

Set-up builds the trainer and the loader once, drives the first
``CHECKED_STEPS`` steps through the same call and feed, keeps what the
reference needs of them, and warms up until every bucket of the traffic has
been stepped. The window then steps for ``--seconds``: ``train_img_per_s``
is every image stepped over the time from the first step's start to the last
step's synchronised end. Once it has closed and the trainer is freed, the
reference rebuilds the checked steps' batches from the records and the seed,
steps its copy of the detector through them with the same draws, and the
two are compared (``harness/compare.py``).

Traced (``--trace 1``): the stage marks of every step on CUDA events, a span
around every ``next()`` of the prefetch, and a profiler stretch of
``PROFILED_STEPS`` steps.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.harness import compare, prepare
from perfbench.harness.core import Run, peak_memory, program_cfg, release, sync
from perfbench.harness.trace import Marks, Profile, Spans

CHECKED_STEPS = 3
MIN_WARM_STEPS = 6
MAX_WARM_STEPS = 40
READ_EVERY = 20      # do_train reads the step's metrics every 20 iterations
PROFILE_AFTER = 8    # window steps before the profiled stretch
PROFILED_STEPS = 6
LOSSES = ("total_loss",)  # the step's losses the comparison reads


def _host(batch):
    return {"images": batch.images.cpu(), "image_hw": batch.image_hw.cpu(), "boxes": batch.gt.boxes.cpu(),
            "classes": batch.gt.classes.cpu(), "valid": batch.gt.valid.cpu()}


def _norms(tensors):
    return torch.stack([torch.linalg.vector_norm(t.detach().double()) for t in tensors]).cpu().tolist()


def setup(r: Run) -> dict:
    from openset_rcnn_tpu_torch.data import TrainLoader, device_prefetch
    from openset_rcnn_tpu_torch.engine.train_loop import build_train_transform
    from openset_rcnn_tpu_torch.engine.train_state import Trainer, trainable_names

    cfg = program_cfg(r.config)
    data = prepare.make_traffic(r)
    weights = prepare.weights(r, data)
    batch_size = cfg.SOLVER.IMS_PER_BATCH
    trainer = Trainer(cfg, r.device, state_dict=weights, seed=r.sub_seed("trainer"))
    loader_seed = r.sub_seed("loader")
    loader = TrainLoader(data.records, build_train_transform(cfg), batch_size=batch_size, seed=loader_seed,
                         filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS,
                         num_workers=cfg.DATALOADER.NUM_WORKERS)
    stream = device_prefetch(iter(loader), r.device)
    draws = prepare.Draws(r, r.config["cfg"], batch_size)
    names = trainable_names(trainer.model)
    params = [p for p in trainer.model.parameters() if p.requires_grad]
    checked = {"batches": [], "draws": [], "losses": []}
    buckets = {tuple(cfg.TPU.TRAIN_BUCKET) if rec["width"] >= rec["height"] else tuple(cfg.TPU.TRAIN_BUCKET)[::-1]
               for rec in data.records}
    seen, steps = set(), 0
    while steps < CHECKED_STEPS or steps < MIN_WARM_STEPS or not buckets <= seen:
        if steps >= MAX_WARM_STEPS:
            raise RuntimeError(f"warm-up saw buckets {seen} of {buckets} in {steps} steps")
        batch, _ = next(stream)
        u = draws.next()
        if steps < CHECKED_STEPS:
            checked["batches"].append(_host(batch))
            checked["draws"].append({k: v.cpu() for k, v in u.items()})
        metrics = trainer.step(batch, uniforms=u)
        seen.add(tuple(batch.images.shape[1:3]))
        if steps < CHECKED_STEPS:
            checked["losses"].append({k: metrics[k].detach().clone() for k in LOSSES})
        if steps == 0:
            state = trainer.state.optimizer.state
            # a parameter the step left without a momentum buffer took no gradient
            bufs = [state.get(p, {}).get("momentum_buffer", torch.zeros((), device=p.device)) for p in params]
            checked["first_grad_norms"] = dict(zip(names, _norms(bufs)))
        if steps == CHECKED_STEPS - 1:
            checked["change_norms"] = dict(zip(names, _norms([p - weights[n] for n, p in zip(names, params)])))
        steps += 1
    checked["losses"] = [{k: float(v) for k, v in step.items()} for step in checked["losses"]]
    return {"cfg": cfg, "data": data, "weights": weights, "trainer": trainer, "stream": stream, "draws": draws,
            "checked": checked, "batch_size": batch_size, "loader_seed": loader_seed, "names": names}


def window(r: Run, s: dict) -> None:
    trainer, stream, draws, batch_size = s["trainer"], s["stream"], s["draws"], s["batch_size"]
    marks, spans, profile = (Marks(), Spans(), Profile()) if r.trace else (None, None, None)
    steps, failed = 0, 0
    t0 = time.perf_counter()
    while True:
        if profile is not None and steps == PROFILE_AFTER:
            profile.start()
        if spans is not None:
            with spans.span("data_wait"):
                batch, _ = next(stream)
            marks.begin()
        else:
            batch, _ = next(stream)
        metrics = trainer.step(batch, uniforms=draws.next(), mark=marks)
        steps += 1
        if profile is not None and profile.active and steps == PROFILE_AFTER + PROFILED_STEPS:
            profile.stop()
        if steps % READ_EVERY == 0:
            if not math.isfinite(float(metrics["total_loss"])):
                failed += READ_EVERY
        if time.perf_counter() - t0 >= r.seconds and (profile is None or not profile.active):
            break
    if not math.isfinite(float(metrics["total_loss"])):
        failed += steps % READ_EVERY or READ_EVERY
    sync()
    elapsed = time.perf_counter() - t0
    r.e2e["train_img_per_s"] = steps * batch_size / elapsed
    r.attempted, r.failed = steps * batch_size, min(failed, steps) * batch_size
    r.memory_peak_bytes = peak_memory(r.device)
    if r.trace:
        r.profile = profile.summary()
        r.per_layer_inputs.update(marks=marks, spans=spans, steps=steps, window_s=elapsed,
                                  images=steps * batch_size, batch=batch_size)


def reference_numbers(r: Run, s: dict, precision: str = "stated") -> dict:
    """The reference's steps over the checked batches, rebuilt from the
    records and the loader's seed, with the same draws: the numbers compared,
    the transform's gap among them."""
    from perfbench.reference.data import order
    from perfbench.reference.model import Reference
    from perfbench.reference.structures import GroundTruth, ImageBatch

    cfg = r.config["cfg"]
    records = order.usable(s["data"].records) if cfg["DATALOADER"]["FILTER_EMPTY_ANNOTATIONS"] else s["data"].records
    transform = prepare.reference_transform(cfg, train=True)
    transform.read_image = s["data"].read_image
    batches, gap = [], 0.0
    for got, slots in zip(s["checked"]["batches"], order.batches(records, s["batch_size"], s["loader_seed"])):
        ex = [transform(records[i], order.example_rng(s["loader_seed"], seq)) for seq, i in slots]
        want = {"images": torch.from_numpy(np.stack([e.image for e in ex])),
                "image_hw": torch.tensor([e.image_hw for e in ex], dtype=torch.float32),
                "boxes": torch.from_numpy(np.stack([e.boxes for e in ex])),
                "classes": torch.from_numpy(np.stack([e.classes for e in ex])),
                "valid": torch.from_numpy(np.stack([e.gt_valid for e in ex]))}
        for k in ("image_hw", "classes", "valid"):
            if got[k].shape != want[k].shape or not torch.equal(got[k].to(want[k].dtype), want[k]):
                gap = math.inf
        if gap == 0.0:
            gap = max(float((got["images"].int() - want["images"].int()).abs().max()),
                      float((got["boxes"] - want["boxes"]).abs().max()))
        batches.append(ImageBatch(want["images"], want["image_hw"],
                                  GroundTruth(want["boxes"], want["classes"], want["valid"])))
    ref = Reference(cfg, s["weights"], r.device, precision).train(batches, s["checked"]["draws"])
    return {"transform_gap": gap, "ref": ref}


def _steps(ref: dict) -> dict:
    """A reference's steps as the program's checked steps are kept."""
    return {"losses": ref["losses"], "first_grad_norms": dict(zip(ref["names"], ref["first_grad_norms"])),
            "change_norms": dict(zip(ref["names"], ref["change_norms"]))}


def numbers(r: Run, s: dict, control: str = None) -> dict:
    """The numbers of the checked steps against the reference's
    (``harness/compare.py``), the transform's gap among them; with
    ``control`` (a precision) the reference in that precision stands in for
    the program, its transform the reference's own."""
    out = reference_numbers(r, s)
    ref = out["ref"]
    prog = s["checked"] if control is None else _steps(reference_numbers(r, s, control)["ref"])
    names = ref["names"]
    if set(names) != set(prog["first_grad_norms"]):
        numbers = {k: math.inf for k in ("loss_gap", "loss1_gap", "grad_gap", "grad_median_gap", "update_gap",
                                         "update_median_gap")}
    else:
        numbers = compare.train_numbers({"losses": prog["losses"],
                                         "first_grad_norms": [prog["first_grad_norms"][n] for n in names],
                                         "change_norms": [prog["change_norms"][n] for n in names]}, ref)
    numbers["transform_gap"] = out["transform_gap"] if control is None else 0.0
    numbers["losses"] = {"program": [x["total_loss"] for x in prog["losses"]],
                         "reference": [x["total_loss"] for x in ref["losses"]]}
    return numbers


def free(s: dict) -> None:
    for k in ("trainer", "stream", "draws"):
        s.pop(k, None)
    release()
