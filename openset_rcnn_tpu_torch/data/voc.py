"""PASCAL-VOC XML dataset loading + the VOC-COCO open-set class list.

Copy of ``openset_rcnn_tpu/data/voc.py``, kept in the port so
that it imports nothing of the JAX package.

Host-side rebuild of d2's ``load_voc_instances`` (consumed by the reference
through data/voc_coco.py:33) and the 81-name VOC-COCO category list
(data/voc_coco.py:5-27 — 20 VOC + 60 COCO + "unknown"; a static dataset
fact reproduced for parity). The d2 convention of subtracting 1 from
xmin/ymin (VOC's 1-based coordinates) is preserved; the evaluator adds it
back (evaluation/voc_eval.py).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

# 20 VOC + 60 COCO (in the OpenDet split order) + "unknown".
VOC_COCO_CATEGORIES = list(VOC_CLASSES) + [
    # COCO classes 20-40
    "truck", "traffic light", "fire hydrant", "stop sign", "parking meter",
    "bench", "elephant", "bear", "zebra", "giraffe",
    "backpack", "umbrella", "handbag", "tie", "suitcase",
    "microwave", "oven", "toaster", "sink", "refrigerator",
    # COCO classes 40-60
    "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard", "tennis racket",
    "banana", "apple", "sandwich", "orange", "broccoli",
    "carrot", "hot dog", "pizza", "donut", "cake",
    # COCO classes 60-80
    "bed", "toilet", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "book", "clock",
    "vase", "scissors", "teddy bear", "hair drier", "toothbrush",
    "wine glass", "cup", "fork", "knife", "spoon", "bowl",
    "unknown",
]


def parse_voc_xml(path: str, class_to_id) -> List[dict]:
    """Annotations for one image; classes absent from the map are skipped."""
    tree = ET.parse(path)
    out = []
    for obj in tree.findall("object"):
        name = obj.find("name").text
        if name not in class_to_id:
            continue
        bndbox = obj.find("bndbox")
        x1 = float(bndbox.find("xmin").text)
        y1 = float(bndbox.find("ymin").text)
        x2 = float(bndbox.find("xmax").text)
        y2 = float(bndbox.find("ymax").text)
        diff_node = obj.find("difficult")
        difficult = int(diff_node.text) if diff_node is not None else 0
        out.append(
            {
                # 1-based VOC corner -> 0-based (d2 convention)
                "bbox": [x1 - 1.0, y1 - 1.0, x2, y2],
                "category_id": class_to_id[name],
                "category_name": name,
                "difficult": difficult,
            }
        )
    return out


def load_voc_instances(dirname: str, split: str, class_names: Sequence[str]) -> List[dict]:
    """Dataset dicts for a VOC-style directory (JPEGImages/Annotations/ImageSets)."""
    class_to_id = {c: i for i, c in enumerate(class_names)}
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        image_ids = [line.strip() for line in f if line.strip()]

    dicts = []
    for image_id in image_ids:
        anno_path = os.path.join(dirname, "Annotations", image_id + ".xml")
        jpeg_path = os.path.join(dirname, "JPEGImages", image_id + ".jpg")
        tree = ET.parse(anno_path)
        size = tree.find("size")
        record = {
            "file_name": jpeg_path,
            "image_id": image_id,
            "height": int(size.find("height").text),
            "width": int(size.find("width").text),
            "annotations": parse_voc_xml(anno_path, class_to_id),
        }
        dicts.append(record)
    return dicts


def load_voc_gt_for_eval(dirname: str, split: str) -> List[dict]:
    """GT in raw XML coordinates for the open-set evaluator: every object is
    kept with its original class NAME (the evaluator maps unseen names to
    'unknown')."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        image_ids = [line.strip() for line in f if line.strip()]
    out = []
    for image_id in image_ids:
        tree = ET.parse(os.path.join(dirname, "Annotations", image_id + ".xml"))
        boxes, names, difficult = [], [], []
        for obj in tree.findall("object"):
            bb = obj.find("bndbox")
            boxes.append(
                [
                    int(bb.find("xmin").text),
                    int(bb.find("ymin").text),
                    int(bb.find("xmax").text),
                    int(bb.find("ymax").text),
                ]
            )
            names.append(obj.find("name").text)
            d = obj.find("difficult")
            difficult.append(bool(int(d.text)) if d is not None else False)
        out.append(
            {"image_id": image_id, "boxes": boxes, "class_names": names, "difficult": difficult}
        )
    return out
