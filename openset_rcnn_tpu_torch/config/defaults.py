"""Default configuration.

Copy of ``openset_rcnn_tpu/config/defaults.py``, so that the port imports
nothing of the JAX package. The ``TPU`` node keeps its name: the YAML configs
are shared by both packages.

Covers the subset of detectron2's default config tree the reference composes
(SURVEY.md §2.4, §5.6) plus the Openset-RCNN extras added by
``add_openset_rcnn_config`` (reference: openset_rcnn/config/config.py:6-43).
Key names match the reference so its YAML configs port 1:1, with a small
``TPU`` node for TPU-specific static-shape/bucketing knobs that have no
reference equivalent.
"""
from .cfg_node import CfgNode as CN


def get_default_cfg() -> CN:
    _C = CN()
    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1
    _C.OPENDET_BENCHMARK = False

    # ------------------------------------------------------------------ MODEL
    _C.MODEL = CN()
    _C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.MASK_ON = False
    # BGR means, matching d2's GeneralizedRCNN preprocessing (SURVEY.md §2.4)
    _C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

    _C.MODEL.BACKBONE = CN()
    _C.MODEL.BACKBONE.NAME = "build_resnet_fpn_backbone"
    _C.MODEL.BACKBONE.FREEZE_AT = 2

    _C.MODEL.RESNETS = CN()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True

    # Swin backbone (BASELINE stretch; not in the reference yacs tree —
    # selected via MODEL.BACKBONE.NAME build_swin_fpn_backbone)
    _C.MODEL.SWIN = CN()
    _C.MODEL.SWIN.SIZE = "T"  # T | S | B (models/swin.py SWIN_VARIANTS)
    _C.MODEL.SWIN.WINDOW = 7
    _C.MODEL.SWIN.DROP_PATH_RATE = 0.0  # stochastic depth (public recipe: 0.2);
                                        # 0.0 = converted-weight parity

    # ViT backbone (BASELINE stretch; ViTDet simple-FPN recipe —
    # selected via MODEL.BACKBONE.NAME build_vit_fpn_backbone)
    _C.MODEL.VIT = CN()
    _C.MODEL.VIT.DROP_PATH_RATE = 0.0  # ViTDet-B fine-tune recipe: 0.1;
                                       # 0.0 = converted-weight parity

    # MViTv2 backbone (Li et al., arXiv:2112.01526, as detectron2's
    # projects/MViTv2 builds it for detection; models/mvit.py) — selected via
    # MODEL.BACKBONE.NAME build_mvit_fpn_backbone. Defaults: MViTv2-T.
    _C.MODEL.MVIT = CN()
    _C.MODEL.MVIT.EMBED_DIM = 96  # width of stage 1; doubles at each stage end
    _C.MODEL.MVIT.DEPTH = 10  # blocks in all
    _C.MODEL.MVIT.NUM_HEADS = 1  # heads of stage 1; double at each stage end
    _C.MODEL.MVIT.LAST_BLOCK_INDEXES = [0, 2, 7, 9]  # the block ending each of the four stages
    _C.MODEL.MVIT.QKV_POOL_KERNEL = 3  # the depthwise pooling convolutions' kernel
    _C.MODEL.MVIT.ADAPTIVE_KV_STRIDE = 4  # k/v pooling stride of stage 1; halves per stage, at least 1
    _C.MODEL.MVIT.ADAPTIVE_WINDOW_SIZE = 56  # attention window of stage 1 (before pooling); halves per stage
    _C.MODEL.MVIT.RESIDUAL_POOLING = True  # add the pooled q to the attention output
    _C.MODEL.MVIT.MLP_RATIO = 4.0
    _C.MODEL.MVIT.PRETRAIN_SIZE = 224  # sizes the relative-position tables (PRETRAIN_SIZE // 4 a side)
    _C.MODEL.MVIT.DROP_PATH_RATE = 0.0  # stochastic depth, linspace(0, rate) over the blocks;
                                        # 0.0 = converted-weight parity

    # EVA-02 in the ViTDet frame (Fang et al., arXiv:2303.11331; baaivision/EVA
    # EVA-02/det; models/vit.py) — selected via MODEL.BACKBONE.NAME
    # build_eva02_fpn_backbone. Defaults: EVA-02-L.
    _C.MODEL.EVA02 = CN()
    _C.MODEL.EVA02.EMBED_DIM = 1024
    _C.MODEL.EVA02.DEPTH = 24
    _C.MODEL.EVA02.NUM_HEADS = 16
    _C.MODEL.EVA02.MLP_HIDDEN = 2730  # SwiGLU's hidden width, int(1024 * 4 * 2 / 3)
    _C.MODEL.EVA02.WINDOW_SIZE = 16  # windowed blocks' window, padded bottom and right
    _C.MODEL.EVA02.GLOBAL_BLOCKS = [2, 5, 8, 11, 14, 17, 20, 23]  # blocks that attend globally
    _C.MODEL.EVA02.POS_GRID = 16  # the absolute position table's side, resized to the patch grid
    _C.MODEL.EVA02.ROPE_PT = 16  # RoPE's pre-training grid side: positions scale by PT / FT
    _C.MODEL.EVA02.ROPE_GLOBAL_FT = 96  # RoPE's grid side in global blocks (a window's is WINDOW_SIZE)
    _C.MODEL.EVA02.DROP_PATH_RATE = 0.0  # stochastic depth, linspace(0, rate) over the blocks

    _C.MODEL.FPN = CN()
    _C.MODEL.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.FUSE_TYPE = "sum"

    _C.MODEL.ANCHOR_GENERATOR = CN()
    _C.MODEL.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    _C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    _C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

    _C.MODEL.PROPOSAL_GENERATOR = CN()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "ClsFreeRPN"
    _C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

    _C.MODEL.RPN = CN()
    _C.MODEL.RPN.HEAD_NAME = "ClsFreeRPNHead"
    _C.MODEL.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    _C.MODEL.RPN.CONV_DIMS = [-1]
    _C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
    _C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    _C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    _C.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
    _C.MODEL.RPN.LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.BOUNDARY_THRESH = -1
    _C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 2000
    _C.MODEL.RPN.PRE_NMS_TOPK_TEST = 1000
    _C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 1000
    _C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    _C.MODEL.RPN.NMS_THRESH = 0.7
    # --- Openset-RCNN extras (reference config/config.py:12-17) ---
    _C.MODEL.RPN.CTR_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.CTR_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RPN.CTR_SMOOTH_L1_BETA = 0.0
    _C.MODEL.RPN.IOU_THRESHOLDS_OBJECTNESS = [0.1, 0.3]
    _C.MODEL.RPN.POSITIVE_FRACTION_OBJECTNESS = 1.0
    _C.MODEL.RPN.NMS_THRESH_TEST = 1.0
    # TPU extra: >0 removes the IoU-loss zero-area saddle for from-scratch runs
    _C.MODEL.RPN.DELTA_BIAS_INIT = 0.0

    _C.MODEL.ROI_HEADS = CN()
    _C.MODEL.ROI_HEADS.NAME = "OpensetROIHeads"
    _C.MODEL.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    _C.MODEL.ROI_HEADS.NUM_CLASSES = 80
    _C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
    _C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
    _C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    _C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    _C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True
    _C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    _C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    # --- Openset-RCNN extras (reference config/config.py:24-33) ---
    _C.MODEL.ROI_HEADS.MEAN_TYPE = "geometric"
    _C.MODEL.ROI_HEADS.OBJ_SCORE_THRESH_TEST = 0.05
    _C.MODEL.ROI_HEADS.NUM_KNOWN_CLASSES = 20
    _C.MODEL.ROI_HEADS.KNOWN_SCORE_THRESH = 0.05
    _C.MODEL.ROI_HEADS.KNOWN_NMS_THRESH = 0.5
    _C.MODEL.ROI_HEADS.KNOWN_TOPK = 1000
    _C.MODEL.ROI_HEADS.UNKNOWN_SCORE_THRESH = 0.05
    _C.MODEL.ROI_HEADS.UNKNOWN_NMS_THRESH = 0.5
    _C.MODEL.ROI_HEADS.UNKNOWN_TOPK = 1000
    _C.MODEL.ROI_HEADS.UNKNOWN_ID = 1000

    _C.MODEL.ROI_BOX_HEAD = CN()
    _C.MODEL.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    _C.MODEL.ROI_BOX_HEAD.NUM_FC = 2
    _C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    _C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    _C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    _C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    _C.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False
    # --- Openset-RCNN extras (reference config/config.py:19-22) ---
    _C.MODEL.ROI_BOX_HEAD.IOU_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_BOX_HEAD.IOU_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.ROI_BOX_HEAD.IOU_SMOOTH_L1_BETA = 0.0
    _C.MODEL.ROI_BOX_HEAD.CLS_LOSS_WEIGHT = 1.0

    # --- Prototype Learning Network (reference config/config.py:35-43) ---
    _C.MODEL.PLN = CN()
    _C.MODEL.PLN.EMD_DIM = 256
    _C.MODEL.PLN.DISTANCE_TYPE = "COS"  # L1, L2, COS
    _C.MODEL.PLN.REPS_PER_CLASS = 1
    _C.MODEL.PLN.ALPHA = 0.1
    _C.MODEL.PLN.BETA = 0.9
    _C.MODEL.PLN.IOU_THRESHOLD = 0.5
    _C.MODEL.PLN.UNK_THR = 0.4
    _C.MODEL.PLN.LOSS_WEIGHT = 2.0

    # ------------------------------------------------------------------ DATA
    _C.DATASETS = CN()
    _C.DATASETS.TRAIN = ()
    _C.DATASETS.TEST = ()

    _C.DATALOADER = CN()
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    _C.INPUT = CN()
    _C.INPUT.MIN_SIZE_TRAIN = (640, 672, 704, 736, 768, 800)
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 800
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.RANDOM_FLIP = "horizontal"
    _C.INPUT.FORMAT = "BGR"

    # ---------------------------------------------------------------- SOLVER
    _C.SOLVER = CN()
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.BASE_LR = 0.02
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (60000, 80000)
    _C.SOLVER.MAX_ITER = 90000
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.CLIP_GRADIENTS = CN()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"

    # ------------------------------------------------------------------ TEST
    _C.TEST = CN()
    _C.TEST.EVAL_PERIOD = 0
    _C.TEST.DETECTIONS_PER_IMAGE = 100

    # ------------------------------------------------- TPU-native extensions
    # Static-shape knobs; no reference equivalent (SURVEY.md §7.1).
    _C.TPU = CN()
    _C.TPU.MAX_GT_PER_IMAGE = 100          # GT boxes padded per image
    _C.TPU.TRAIN_BUCKET = (832, 1344)      # train pad bucket (H, W), /32 divisible
    _C.TPU.TEST_BUCKET = (832, 1344)       # test pad bucket (H, W)
    _C.TPU.SIZE_DIVISIBILITY = 32
    _C.TPU.ROI_SAMPLING_RATIO = 2          # RoIAlign samples/bin axis (static);
                                           #  -1: d2 adaptive ceil(roi/7) (parity)
    _C.TPU.ROI_ALIGN_IMPL = "auto"         # auto|gather|pallas (auto: pallas on 1-chip TPU)
    _C.TPU.ROI_ALIGN_BWD = "pallas"        # pallas (window RMW kernel) | xla
                                           #  | pallas_bf16 (bf16 grad accs:
                                           #  half the RMW traffic, opt-in)
    _C.TPU.RPN_MATCHER = "auto"            # auto|pallas|xla (fused IoU+matcher kernel)
                                           #  (scatter-add); pallas impl only
    _C.TPU.MAX_DETECTIONS_DEVICE = 100     # fused on-device inference cap
    _C.TPU.EVAL_BATCH_SIZE = 8             # eval images per device dispatch
    _C.TPU.EVAL_FUSED = True               # fuse the 3-stage cascade on-device
    _C.TPU.EVAL_MESH = True                # single-process multi-chip: shard the
                                           # eval batch over gcd(EVAL_BATCH_SIZE,
                                           # n_devices) chips
                                           #  (False: exact host cascade oracle)
    _C.TPU.RESIZE_INTERP = "pil"           # pil (reference-exact PIL BILINEAR,
                                           #  antialiased downsample) | cv2
    _C.TPU.DTYPE = "float32"               # compute dtype for conv trunk
    _C.TPU.REMAT = False                   # rematerialize backbone blocks
    _C.TPU.MESH_DATA = 1                   # data-parallel axis size (-1: all devices;
                                           #  default 1 mirrors the reference --num-gpus 1)
    _C.TPU.MESH_MODEL = 1                  # model-parallel axis size

    return _C


def add_openset_rcnn_config(cfg: CN) -> CN:
    """Kept for interface parity with the reference
    (openset_rcnn/config/config.py:6); our defaults already include the
    openset keys, so this is a no-op returning cfg."""
    return cfg
