"""Openset-RCNN training/eval CLI of the PyTorch port, on one GPU.

The twin of the JAX package's ``train.py`` (same flags, with ``--num-gpus``
for ``--num-chips``):

  python -m openset_rcnn_tpu_torch.train \\
      --config-file configs/VOC-COCO/openset_rcnn_R50_FPN_128k_tpu.yaml \\
      [--eval-only [--test_iter N]] [--resume] [--resume_test] \\
      [--eval_type openset|cls_agn_unk|proposals] [--opendet-benchmark] \\
      [--profile-steps N] [--debug-nans] [KEY VALUE ...]

It trains on the GPU (``main(args, device="cpu")`` runs the plain versions of
the kernels on the CPU). Data-parallel training is not ported yet (ROADMAP.md
queue A item 5): ``--num-gpus`` > 1, ``--num-machines`` > 1 and
``--dist-url`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Union

logger = logging.getLogger("openset_rcnn_tpu_torch")


def setup(args):
    """The config of ``args`` (file, flags, KEY VALUE pairs), frozen; writes
    ``config.yaml`` and starts ``log.txt`` in its OUTPUT_DIR."""
    from openset_rcnn_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opendet_benchmark:
        cfg.OPENDET_BENCHMARK = True
    cfg.merge_from_list(args.opts)
    if args.num_gpus > 0:
        # --num-gpus N sets the data-parallel axis; only 1 runs until DDP
        cfg.TPU.MESH_DATA = args.num_gpus
    cfg.freeze()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)

    fmt = logging.Formatter("[%(asctime)s %(name)s]: %(message)s", datefmt="%m/%d %H:%M:%S")
    logging.basicConfig(level=logging.INFO, format=fmt._fmt, datefmt=fmt.datefmt)
    logger.setLevel(logging.INFO)
    # log.txt of this OUTPUT_DIR, once, whatever handlers the process had
    path = os.path.abspath(os.path.join(cfg.OUTPUT_DIR, "log.txt"))
    root = logging.getLogger()
    if not any(getattr(h, "baseFilename", None) == path for h in root.handlers):
        handler = logging.FileHandler(path)
        handler.setFormatter(fmt)
        root.addHandler(handler)
    with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    logger.info("Running with config:\n%s", cfg.dump())
    return cfg


def main(args, device: Optional[Union[str, "torch.device"]] = None):  # noqa: F821
    """Run the CLI's task; ``device`` is the GPU unless given."""
    if args.num_gpus > 1 or args.num_machines > 1 or args.dist_url:
        raise NotImplementedError("--num-gpus > 1, --num-machines > 1 and --dist-url need data-parallel training "
                                  "(DDP over NCCL), which is not ported yet: ROADMAP.md queue A item 5")
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
    parser.add_argument("--num-gpus", type=int, default=-1, help="data-parallel GPUs (only 1 until DDP)")
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
