"""The class names of the VOC-COCO open-set benchmark: the 20 VOC classes
(known), 60 COCO classes (unknown) and "unknown".

Frozen copy of ``VOC_COCO_CATEGORIES`` of
``openset_rcnn_tpu_torch/data/voc.py``.
"""

VOC_COCO_CATEGORIES = [
    'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
    'car', 'cat', 'chair', 'cow', 'diningtable', 'dog',
    'horse', 'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
    'train', 'tvmonitor', 'truck', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'elephant', 'bear', 'zebra', 'giraffe',
    'backpack', 'umbrella', 'handbag', 'tie', 'suitcase', 'microwave',
    'oven', 'toaster', 'sink', 'refrigerator', 'frisbee', 'skis',
    'snowboard', 'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
    'surfboard', 'tennis racket', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake',
    'bed', 'toilet', 'laptop', 'mouse', 'remote', 'keyboard',
    'cell phone', 'book', 'clock', 'vase', 'scissors', 'teddy bear',
    'hair drier', 'toothbrush', 'wine glass', 'cup', 'fork', 'knife',
    'spoon', 'bowl', 'unknown',
]
