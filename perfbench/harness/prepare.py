"""Set-up that every entry loop shares: the traffic, the weights, the
reference's transforms and the sampling draws of a training step.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import traffic as traffic_gen
from .core import Run
from .weights import calibrate_frozen_bn, calibrate_prototypes, make_weights


def make_traffic(r: Run) -> traffic_gen.Traffic:
    return traffic_gen.generate(r.traffic, r.sub_seed("traffic"), os.path.join(r.workdir, "images"))


def reference_transform(cfg: Dict, train: bool):
    """The reference's copy of the program's transform of ``cfg``."""
    from ..reference.data.transforms import DetectionTransform

    i, t = cfg["INPUT"], cfg["TPU"]
    return DetectionTransform(
        min_sizes=tuple(i["MIN_SIZE_TRAIN"]) if train else (i["MIN_SIZE_TEST"],),
        max_size=i["MAX_SIZE_TRAIN"] if train else i["MAX_SIZE_TEST"],
        bucket_hw=tuple(t["TRAIN_BUCKET"] if train else t["TEST_BUCKET"]),
        max_gt=t["MAX_GT_PER_IMAGE"],
        flip=train and i["RANDOM_FLIP"] == "horizontal",
        fmt=i["FORMAT"],
        interp=t["RESIZE_INTERP"],
    )


CALIBRATED = (".mean", ".var", "pln.encoder.bias", "pln.representatives", "classifier.cls_score.weight",
              "classifier.cls_score.bias")


def weights(r: Run, data: traffic_gen.Traffic) -> Dict[str, torch.Tensor]:
    """The run's weights on the card: the configuration's recipe from the
    run's seed, then, in the reference's forward over the first traffic
    images of the first image's bucket, FrozenBN statistics
    (``calibrate_frozen_bn`` images) and PLN's prototypes with the known
    classifier (``prototypes``: over ``images`` images, with ``near_share``
    and ``logit``; ``harness/weights.py``)."""
    from ..reference.model import Reference, skeleton
    from ..reference.models.resnet import FrozenBN

    cfg = r.config["cfg"]
    recipe = r.config["weights"]
    state = make_weights(skeleton(cfg), recipe["rules"], r.sub_seed("weights"), r.device)
    n_bn = int(recipe.get("calibrate_frozen_bn", 0))
    proto = recipe.get("prototypes")
    n = max(n_bn, int(proto["images"]) if proto else 0)
    if not n:
        return state
    transform = reference_transform(cfg, train=False)
    transform.read_image = data.read_image
    examples = [transform(rec, np.random.RandomState(0)) for rec in data.records[: 8 * n]]
    bucket = examples[0].bucket_hw
    examples = [e for e in examples if e.bucket_hw == bucket][:n]
    ref = Reference(cfg, state, r.device)
    images = torch.from_numpy(np.stack([e.image for e in examples])).to(r.device)
    hw = torch.tensor([e.image_hw for e in examples], dtype=torch.float32, device=r.device)
    if n_bn:
        calibrate_frozen_bn(ref.model, lambda: ref.model.features(images[:n_bn], hw[:n_bn]), FrozenBN)
    if proto:
        h_props, h_gt = ref.box_head_outputs(images, hw, [e.boxes[e.gt_valid] for e in examples])
        classes = np.concatenate([e.classes[e.gt_valid] for e in examples])
        m = cfg["MODEL"]
        if m["PLN"]["DISTANCE_TYPE"] != "COS":
            raise ValueError("the prototypes are placed for the cosine distance only")
        src = prototype_sources([int(c) for c in classes], m["ROI_HEADS"]["NUM_KNOWN_CLASSES"],
                                m["PLN"]["REPS_PER_CLASS"])
        alpha, share = calibrate_prototypes(ref.model, h_props, h_gt[src], float(proto["near_share"]),
                                            float(proto["logit"]), float(m["PLN"]["UNK_THR"]))
        r.notes["prototypes"] = {"alpha": alpha, "near_share": share, "sources": len(set(src)),
                                 "gt_boxes": len(classes)}
    for name, t in ref.model.state_dict().items():
        if name.endswith(CALIBRATED):
            state[name] = t.detach().clone().contiguous()
    del ref, images
    return state


def prototype_sources(classes: List[int], num_known: int, reps_per_class: int) -> List[int]:
    """For each prototype (class-major), the index of its source box among
    the ground truth of ``classes``: a box of its own class not taken yet,
    else the first box not taken yet, else the boxes again in turn."""
    if not classes:
        raise ValueError("the prototypes need ground-truth boxes in the first traffic images")
    taken, out = set(), []
    for slot in range(num_known * reps_per_class):
        c = slot // reps_per_class
        free = [i for i in range(len(classes)) if i not in taken]
        own = [i for i in free if classes[i] == c]
        i = own[0] if own else free[0] if free else slot % len(classes)
        taken.add(i)
        out.append(i)
    return out


class Draws:
    """The sampling draws of each training step, made by the benchmark from
    the run's seed on the card and handed to ``Trainer.step`` and to the
    reference alike: "rpn" (B, 2, 2, R) and "roi" (B, 3, P + G), the shapes
    of ``rpn_targets`` and ``label_and_sample_proposals`` (P: the
    proposals the per-level top-k keeps, G: the padded GT)."""

    def __init__(self, r: Run, cfg: Dict, batch: int):
        from ..reference.models.detector import RPN_STRIDES
        from ..reference.ops.anchors import fpn_anchors

        m = cfg["MODEL"]
        levels = fpn_anchors(tuple(cfg["TPU"]["TRAIN_BUCKET"]), RPN_STRIDES,
                             tuple(tuple(s) for s in m["ANCHOR_GENERATOR"]["SIZES"]),
                             tuple(m["ANCHOR_GENERATOR"]["ASPECT_RATIOS"][0]))
        self.rpn = (batch, 2, 2, sum(a.shape[0] for a in levels))
        p = sum(min(m["RPN"]["PRE_NMS_TOPK_TRAIN"], a.shape[0]) for a in levels)
        self.roi = (batch, 3, p + cfg["TPU"]["MAX_GT_PER_IMAGE"])
        self.device = r.device
        self.g = torch.Generator(device=r.device).manual_seed(r.sub_seed("draws"))

    def next(self) -> Dict[str, torch.Tensor]:
        return {"rpn": torch.rand(self.rpn, generator=self.g, device=self.device),
                "roi": torch.rand(self.roi, generator=self.g, device=self.device)}


def sample(r: Run, ids: List, k: int, what: str) -> List:
    """``k`` of ``ids`` drawn from the run's seed."""
    rng = np.random.RandomState(r.sub_seed(what))
    return [ids[i] for i in sorted(rng.choice(len(ids), size=min(k, len(ids)), replace=False))]


def dets_dict(d) -> Dict[str, np.ndarray]:
    return {"boxes": np.asarray(d.boxes, np.float64).reshape(-1, 4), "scores": np.asarray(d.scores, np.float64),
            "classes": np.asarray(d.classes, np.int64)}


def thresholds(cfg: Dict) -> Tuple[float, float]:
    """(known, unknown) score thresholds of the cascade: a known score is a
    class probability over KNOWN_SCORE_THRESH; an unknown one an objectness
    over OBJ_SCORE_THRESH_TEST (and UNKNOWN_SCORE_THRESH)."""
    rh = cfg["MODEL"]["ROI_HEADS"]
    return float(rh["KNOWN_SCORE_THRESH"]), float(max(rh["OBJ_SCORE_THRESH_TEST"], rh["UNKNOWN_SCORE_THRESH"]))
