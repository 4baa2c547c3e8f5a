"""Rank bodies of ``tests/test_torch_port_ddp.py``.

Each function runs in a gloo process that ``parallel.launch`` spawned, on
the CPU; the module imports the PyTorch port only, so a spawned process
starts without JAX. Rank 0's return value reaches the test.
"""
import os

import torch

from openset_rcnn_tpu_torch.config import get_default_cfg
from openset_rcnn_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

THREADS = 2


def setup_rank(cfg_path, datasets):
    """Threads, the test's datasets and its config, in a spawned process."""
    torch.set_num_threads(THREADS)
    for name, (records, meta) in datasets.items():
        DatasetCatalog.remove(name)
        DatasetCatalog.register(name, lambda r=records: r)
        MetadataCatalog.get(name).update(meta)
    cfg = get_default_cfg()
    cfg.merge_from_file(cfg_path)
    return cfg


def record_draws(path):
    """Save the sampling draws of the first step this process takes."""
    from openset_rcnn_tpu_torch.engine import train_state

    losses = train_state.training_losses_and_stats

    def recording(*args, uniforms=None, **kwargs):
        if not os.path.exists(path):
            torch.save({k: v.clone() for k, v in uniforms.items()}, path)
        return losses(*args, uniforms=uniforms, **kwargs)

    train_state.training_losses_and_stats = recording


def step_from_state(trainer, batch, layout):
    """One step on ``batch`` from the trainer's state, which is restored
    after it: the parameters after the step, and the gradients as the
    optimizer receives them (after DDP's reduction and before clipping),
    the box head's shards gathered (a collective of the model group)."""
    import copy

    from openset_rcnn_tpu_torch.parallel.mesh import MODEL_SHARDED, gather

    model, optimizer = trainer.model, trainer.state.optimizer
    state, momentum, step = (copy.deepcopy(model.state_dict()), copy.deepcopy(optimizer.state_dict()),
                             trainer.state.step)
    grads = {}

    def capture(stage):
        if stage == "backward":
            for name, p in model.named_parameters():
                if p.grad is not None:
                    dim = MODEL_SHARDED.get(name) if layout.model > 1 else None
                    grads[name] = p.grad.clone() if dim is None else gather(p.grad, dim, layout)

    trainer.step(batch, mark=capture)
    after = copy.deepcopy(model.state_dict())
    model.load_state_dict(state)
    optimizer.load_state_dict(momentum)
    trainer.state.step = step
    return after, grads


def first_step(trainer, batch, layout, out, name):
    """Two steps from one state on one batch: whether they give bitwise
    equal parameters (tests/test_torch_port_numerics.py's standard, under
    the layout); rank 0 saves the first one's gradients to ``out/name``."""
    first, grads = step_from_state(trainer, batch, layout)
    second, _ = step_from_state(trainer, batch, layout)
    if rank() == 0:
        torch.save(grads, os.path.join(out, name))
    return all(torch.equal(v, first[k]) for k, v in second.items())


def first_batch(cfg, layout):
    """This rank's share of the loader's first global batch."""
    from openset_rcnn_tpu_torch.engine.train_loop import build_train_transform, load_train_records
    from openset_rcnn_tpu_torch.data import TrainLoader

    loader = TrainLoader(load_train_records(cfg), build_train_transform(cfg), cfg.SOLVER.IMS_PER_BATCH // layout.data,
                         seed=0, shard_id=layout.data_index, num_shards=layout.data, num_workers=1)
    return next(iter(loader))[0]


VOC_CLASSES = ["c0", "c1", "c2", "unknown"]


def voc_merge(seed=0, images=8):
    """Open-set VOC metrics of seeded detections near seeded GT (known
    classes, some mislabelled, unknown objects, false positives), each
    process holding the detections of its images i::N only: the evaluator
    gathers them. Without a group one process holds them all."""
    import numpy as np

    from openset_rcnn_tpu_torch.evaluation.voc_eval import OpensetVocEvaluator
    from openset_rcnn_tpu_torch.parallel import num_processes, process_index

    rng = np.random.RandomState(seed)
    evaluator = OpensetVocEvaluator(VOC_CLASSES, 3)
    for image in range(images):
        xy = rng.uniform(0, 80, (4, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (4, 2))], 1)
        names = [VOC_CLASSES[c] if c < 3 else "other" for c in rng.randint(0, 4, 4)]
        evaluator.add_ground_truth(image, boxes, names, np.zeros(4, bool))
        classes = np.array([VOC_CLASSES.index(n) if n in VOC_CLASSES else 3 for n in names])
        wrong = rng.uniform(size=4) < 0.3
        classes = np.where(wrong, rng.randint(0, 4, 4), classes)
        dets = np.concatenate([boxes + rng.uniform(-3, 3, boxes.shape), [[5.0, 5.0, 30.0, 30.0]]])
        scores, classes = rng.uniform(size=5), np.append(classes, rng.randint(0, 4))
        if image % num_processes() == process_index():
            evaluator.process(image, dets, scores, classes)
    return evaluator.evaluate()


def rank():
    import torch.distributed as dist

    return dist.get_rank()


def data_parallel(cfg_path, datasets, out):
    """A step repeated bitwise (its gradients saved), do_train at the
    config's layout, do_test (fused and proposals) on its step-4
    checkpoint, the VOC evaluator's merge (``voc_merge``), and the group's
    queries; returns rank 0's evaluations and the queries' answers."""
    from openset_rcnn_tpu_torch.engine.train_loop import do_test, do_train
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.parallel import gather_object, reduce_dict
    from openset_rcnn_tpu_torch.parallel.mesh import make_layout

    cfg = setup_rank(cfg_path, datasets)
    layout = make_layout(cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL)
    repeats = first_step(Trainer(cfg, "cpu", seed=0, layout=layout), first_batch(cfg, layout), layout, out,
                         "grads_dp.pt")
    record_draws(os.path.join(out, f"draws_rank{rank()}.pt"))
    step = do_train(cfg, device="cpu").step
    weights = torch.load(os.path.join(cfg.OUTPUT_DIR, "model_0000004.pt"), weights_only=True)["model"]
    fused = do_test(cfg, weights, device="cpu")
    proposals = do_test(cfg, weights, eval_type="proposals", device="cpu")
    try:
        make_layout(3, 1)
        mismatch = None
    except ValueError as e:
        mismatch = str(e)
    return dict(step=step, fused=fused, proposals=proposals, voc=voc_merge(), gathered=gather_object(("rank", rank())),
                reduced=reduce_dict({"rank": float(rank()), "one": 1.0}), mismatch=mismatch,
                repeats=gather_object(repeats))


def model_parallel(cfg_path, datasets, out):
    """MESH_MODEL 2: the gathered init, clipping by the global norm on
    sharded gradients, a step repeated bitwise (its gradients saved), the
    same step's gradients with fc1's input gradient left unsummed (a control
    that must fail the gradient check), the bf16 head's forward, then
    do_train."""
    from openset_rcnn_tpu_torch.engine.optimizer import clip_gradients
    from openset_rcnn_tpu_torch.engine.train_loop import do_train
    from openset_rcnn_tpu_torch.engine.train_state import Trainer
    from openset_rcnn_tpu_torch.models.roi_heads import BoxHead
    from openset_rcnn_tpu_torch.parallel import gather_object, mesh
    from openset_rcnn_tpu_torch.parallel.mesh import gather, gather_state_dict, make_layout, param_sharding

    cfg = setup_rank(cfg_path, datasets)
    layout = make_layout(cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL)
    trainer = Trainer(cfg, "cpu", seed=max(cfg.SEED, 0), layout=layout)
    init = {k: v.clone() for k, v in gather_state_dict(trainer.model.state_dict(), layout).items()}
    shards = {n: tuple(p.shape) for n, p in trainer.model.named_parameters() if n.startswith("box_head.")}

    # clipping: seeded whole gradients, cut to this rank's shards, clipped, gathered
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    params = [p for p in trainer.model.parameters() if p.requires_grad]
    dims = param_sharding(names)
    g = torch.Generator().manual_seed(7)
    whole = [torch.randn(init[n].shape, generator=g) * 0.01 for n in names]
    for p, n, w in zip(params, names, whole):
        p.grad = w.clone() if dims[n] is None else w.chunk(layout.model, dims[n])[layout.model_index].clone()
    clip_gradients(params, "norm", 1.0, sharded=[d is not None for d in dims.values()], model_sum=layout.model_sum)
    clipped = {n: p.grad.clone() if dims[n] is None else gather(p.grad, dims[n], layout)
               for p, n in zip(params, names) if n.startswith("box_head.")}
    trainer.state.optimizer.zero_grad(set_to_none=True)
    batch = first_batch(cfg, layout)
    repeats = first_step(trainer, batch, layout, out, "grads_tp.pt")

    # the control: fc1's input gradient left unsummed over the model group
    copy_backward = mesh._CopyToModelGroup.backward
    mesh._CopyToModelGroup.backward = staticmethod(lambda ctx, grad: (grad, None))
    try:
        _, unsummed = step_from_state(trainer, batch, layout)
    finally:
        mesh._CopyToModelGroup.backward = copy_backward
    if rank() == 0:
        torch.save(unsummed, os.path.join(out, "grads_tp_unsummed.pt"))

    # the bf16 head: sharded forward against the whole head on the same input
    torch.manual_seed(3)
    head = BoxHead(256 * 7 * 7, 1024, torch.bfloat16)
    head.reset_parameters(torch.Generator().manual_seed(5))
    with torch.no_grad():
        head.fc1.weight.mul_(0.02)
    x = torch.randn(2, 8, 7, 7, 256, generator=torch.Generator().manual_seed(9))
    whole_out = head(x)
    head.shard(layout)
    sharded_out = head(x)

    del trainer
    state = do_train(cfg, device="cpu")
    return dict(init=init, shards=shards, whole_grads=dict(zip(names, whole)), clipped=clipped,
                bf16=(whole_out, sharded_out), step=state.step, repeats=gather_object(repeats))
