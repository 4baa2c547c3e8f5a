"""Openset-RCNN training/eval CLI of the PyTorch port, on one GPU or several.

The twin of the JAX package's ``train.py`` (same flags, with ``--num-gpus``
for ``--num-chips``):

  python -m openset_rcnn_tpu_torch.train \\
      --config-file configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml \\
      [--num-gpus N [--num-machines M --machine-rank r --dist-url URL]] \\
      [--eval-only [--test_iter N]] [--resume] [--resume_test] \\
      [--eval_type openset|cls_agn_unk|proposals] [--opendet-benchmark] \\
      [--profile-steps N] [--debug-nans] [KEY VALUE ...]

Several GPUs, as d2's ``launch`` (reference ``train.py:287-294``):
``--num-gpus N`` starts N processes on this machine, one per GPU, in an NCCL
group; on M machines run the command on each with its ``--machine-rank r``
and ``--dist-url tcp://<machine 0>:<port>``, and the ranks are r x N +
local. ``TPU.MESH_DATA`` becomes N x M / ``TPU.MESH_MODEL``
(``parallel/mesh.py``). Without ``--num-gpus``, a config whose
``MESH_DATA x MESH_MODEL`` exceeds 1 starts that many processes. Under
torchrun (``RANK`` and ``WORLD_SIZE`` set) each process joins torchrun's
group. ``--dist-url`` with one process forms a group of one.

It runs on the GPU; ``main(args, device="cpu")`` runs the plain versions of
the kernels on the CPU, in gloo processes when several are asked for.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Union

from openset_rcnn_tpu_torch.parallel import initialize_distributed, launch, num_processes, process_index

logger = logging.getLogger("openset_rcnn_tpu_torch")


def merged_cfg(args):
    """The config of ``args``: file, flags, KEY VALUE pairs."""
    from openset_rcnn_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opendet_benchmark:
        cfg.OPENDET_BENCHMARK = True
    cfg.merge_from_list(args.opts)
    return cfg


def setup(args):
    """The config of ``args``, frozen; writes ``config.yaml`` and starts
    ``log.txt`` in its OUTPUT_DIR."""
    cfg = merged_cfg(args)
    if args.num_gpus > 0:
        # the processes of every machine lay out as data x model
        cfg.TPU.MESH_DATA = max(1, args.num_gpus * args.num_machines // cfg.TPU.MESH_MODEL)
    cfg.freeze()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    rank = process_index()

    fmt = logging.Formatter("[%(asctime)s %(name)s]: %(message)s", datefmt="%m/%d %H:%M:%S")
    logging.basicConfig(level=logging.INFO, format=fmt._fmt, datefmt=fmt.datefmt)
    logger.setLevel(logging.INFO)
    # log.txt of this OUTPUT_DIR (log.txt.rank<r> for rank r > 0), once, whatever handlers the process had
    path = os.path.abspath(os.path.join(cfg.OUTPUT_DIR, "log.txt" if rank == 0 else f"log.txt.rank{rank}"))
    root = logging.getLogger()
    if not any(getattr(h, "baseFilename", None) == path for h in root.handlers):
        handler = logging.FileHandler(path)
        handler.setFormatter(fmt)
        root.addHandler(handler)
    if rank == 0:
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    logger.info("Running with config:\n%s", cfg.dump())
    return cfg


def processes_per_machine(args, cfg, device_type: str) -> int:
    """``--num-gpus``, else the config's ``MESH_DATA x MESH_MODEL`` over the
    machines (``MESH_DATA -1``: every visible GPU)."""
    if args.num_gpus > 0:
        return args.num_gpus
    if cfg.TPU.MESH_DATA == -1:
        import torch

        return torch.cuda.device_count() if device_type == "cuda" else 1
    return max(1, cfg.TPU.MESH_DATA * cfg.TPU.MESH_MODEL // args.num_machines)


def main(args, device: Optional[Union[str, "torch.device"]] = None):  # noqa: F821
    """Run the CLI's task; ``device`` is the GPU unless given.

    One process runs the task here. Several (``--num-gpus``, or the config's
    layout) run it each in its own process, NCCL on CUDA and gloo when
    ``device`` is the CPU, and this returns what rank 0's task returned, a
    training run as its final step; with ``--num-machines`` > 1 each
    machine's command returns when its processes end. ``--resume_test``
    loads no model and runs here alone."""
    import torch

    device_type = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ and num_processes() == 1:
        initialize_distributed(device_type=device_type)  # torchrun started this process
        return run(args, device)
    cfg = merged_cfg(args)
    per_machine = processes_per_machine(args, cfg, device_type)
    if args.resume_test or num_processes() > 1 or (per_machine * args.num_machines == 1 and not args.dist_url):
        return run(args, device)
    return launch(_launched, per_machine, args.num_machines, args.machine_rank, args.dist_url or None,
                  args=(args, device, catalog_entries([*cfg.DATASETS.TRAIN, *cfg.DATASETS.TEST])),
                  device_type=device_type)


def catalog_entries(names):
    """{name: (records, metadata)} of the datasets among ``names`` that this
    process registered, for the processes it starts: a spawned process
    starts with the builtin datasets only."""
    from openset_rcnn_tpu_torch.data import DatasetCatalog, MetadataCatalog

    known = set(DatasetCatalog.list())
    return {n: (DatasetCatalog.get(n), dict(MetadataCatalog.get(n))) for n in dict.fromkeys(names) if n in known}


def _launched(args, device, datasets):
    from openset_rcnn_tpu_torch.data import DatasetCatalog, MetadataCatalog, register_builtin_datasets
    from openset_rcnn_tpu_torch.engine.train_state import TrainState

    register_builtin_datasets()
    for name, (records, meta) in datasets.items():
        DatasetCatalog.remove(name)
        DatasetCatalog.register(name, lambda r=records: r)
        MetadataCatalog.get(name).update(meta)
    result = run(args, device)
    return result.step if isinstance(result, TrainState) else result


def run(args, device: Optional[Union[str, "torch.device"]] = None):  # noqa: F821
    """The CLI's task in this process: re-score (``--resume_test``),
    evaluate (``--eval-only``) or train; the results or the ``TrainState``."""
    cfg = setup(args)

    from openset_rcnn_tpu_torch.data import register_builtin_datasets
    from openset_rcnn_tpu_torch.engine.train_loop import do_test, do_train, get_evaluator

    register_builtin_datasets()

    if args.resume_test:
        # Re-score persisted predictions without touching the model
        # (reference train.py:188-199, os_coco_evaluation.py:177-184).
        results = {}
        for name in cfg.DATASETS.TEST:
            evaluator = get_evaluator(cfg, name, args.eval_type)
            results[name] = evaluator.evaluate(resume=True)
        print(results)
        return results

    if args.eval_only:
        from openset_rcnn_tpu_torch.engine.checkpoint import Checkpointer
        from openset_rcnn_tpu_torch.engine.train_state import Trainer

        seed = max(cfg.SEED, 0)
        state = Trainer(cfg, device, seed=seed).state
        ckpt = Checkpointer(cfg.OUTPUT_DIR)
        if args.test_iter > 0:
            # evaluate a specific checkpoint iteration (reference
            # train.py:242-252)
            ckpt.restore(state, os.path.join(cfg.OUTPUT_DIR, f"model_{args.test_iter:07d}.pt"))
        else:
            ckpt.resume_or_load(state, cfg.MODEL.WEIGHTS, resume=args.resume)
        results = do_test(cfg, state.model.state_dict(), eval_type=args.eval_type, device=device, seed=seed)
        if process_index() == 0:
            print(results)
        return results

    return do_train(cfg, resume=args.resume, profile_steps=args.profile_steps, debug_nans=args.debug_nans,
                    device=device)


def get_parser():
    parser = argparse.ArgumentParser(description="Openset-RCNN (PyTorch port)")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume_test", action="store_true", help="re-score saved predictions")
    parser.add_argument("--test_iter", type=int, default=-1, help="checkpoint iteration to test")
    parser.add_argument(
        "--eval_type",
        default="openset",
        choices=["openset", "cls_agn_unk", "proposals"],
        help="evaluation protocol variant; 'proposals' runs the box-proposals AR task on the CF-RPN outputs",
    )
    parser.add_argument("--opendet-benchmark", action="store_true")
    parser.add_argument("--num-gpus", type=int, default=-1, help="GPUs of this machine, one process each")
    # interface parity with the reference launcher (train.py:264-270)
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="")
    parser.add_argument("--profile-steps", type=int, default=0, help="trace N train steps to OUTPUT_DIR/profile")
    parser.add_argument("--debug-nans", action="store_true", help="run under torch.autograd.detect_anomaly")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
