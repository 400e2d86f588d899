"""Default configuration tree (a copy of lvc_tpu/config/defaults.py; the
port keeps its own copy so that it never imports the JAX package).

Key names and default values mirror the reference's public config surface —
detectron2/config/defaults.py (the subset LVC exercises) layered with
lvc/config/defaults.py:6-223 — so reference YAML configs merge unchanged.
Dead reference blocks (FCOS, TEMPLATE, MOBILENET — SURVEY.md §7 non-goals)
are intentionally omitted. A TPU-only ``PAD`` section adds the static
padding budgets that replace the reference's dynamic shapes.
"""
from lvc_tpu_torch.config.config import CfgNode as CN

_C = CN()
_C.VERSION = 2
_C.DEBUG = False

_C.MODEL = CN()
_C.MODEL.LOAD_PROPOSALS = False
_C.MODEL.MASK_ON = False
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.DEVICE = "cuda"  # informational; build_model(cfg, device=...) places the model
# conv/dense compute dtype ("float32" | "bfloat16"). Params stay f32; box
# decode / NMS / losses always run f32 (see modeling/layers.py).
_C.MODEL.DTYPE = "float32"
_C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
_C.MODEL.WEIGHTS = ""
# BGR order to match INPUT.FORMAT default (d2 defaults.py:38-42)
_C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
_C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]
_C.MODEL.IMAGES_ONLY = False

# ---------------------------------------------------------------------------
# INPUT
# ---------------------------------------------------------------------------
_C.INPUT = CN()
_C.INPUT.MIN_SIZE_TRAIN = (800,)
_C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
_C.INPUT.CROP = CN({"ENABLED": False})
_C.INPUT.CROP.TYPE = "relative_range"
_C.INPUT.CROP.SIZE = [0.9, 0.9]
_C.INPUT.LSJ = False
# emit the production space-to-depth input tensor from the loader
# ("auto": when the backbone stem consumes it; "on"/"off" to force) —
# see data/transforms.py:s2d_canvas
_C.INPUT.LOADER_S2D = "auto"
_C.INPUT.FORMAT = "BGR"
_C.INPUT.MASK_FORMAT = "polygon"
_C.INPUT.COLOR_JITTER = False
_C.INPUT.BLUR = False
_C.INPUT.MOSAIC = 0.0
_C.INPUT.MOSAIC49SPLIT = 0.0

# ---------------------------------------------------------------------------
# DATASETS (incl. LVC few-shot additions, lvc defaults.py:163-206)
# ---------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.PROPOSAL_FILES_TRAIN = ()
_C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
_C.DATASETS.TEST = ()
_C.DATASETS.PROPOSAL_FILES_TEST = ()
_C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000
_C.DATASETS.FINETUNE_SEED = 0
_C.DATASETS.FINETUNE_SHOTS = 30
# COCO novel (unseen) / base (seen) split tables — canonical FSOD split.
_C.DATASETS.UNSEEN_CLASSES = [
    "airplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "dining table", "dog", "horse", "motorcycle",
    "person", "potted plant", "sheep", "couch", "train", "tv"]
_C.DATASETS.SEEN_CLASSES = [
    "truck", "traffic light", "fire hydrant", "stop sign", "parking meter",
    "bench", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "wine glass", "cup", "fork", "knife",
    "spoon", "bowl", "banana", "apple", "sandwich", "orange", "broccoli",
    "carrot", "hot dog", "pizza", "donut", "cake", "bed", "toilet", "laptop",
    "mouse", "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush"]
_C.DATASETS.UNSEEN_IDS = [
    0, 1, 2, 3, 4, 5, 6, 8, 14, 15, 16, 17, 18, 19, 39, 56, 57, 58, 60, 62]
_C.DATASETS.SEEN_IDS = [
    7, 9, 10, 11, 12, 13, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52,
    53, 54, 55, 59, 61, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76,
    77, 78, 79]
_C.DATASETS.ALL_IDS = list(range(80))
_C.DATASETS.SPLIT_IDS = [
    0, 1, 2, 3, 4, 5, 6, 0, 7, 1, 2, 3, 4, 5, 8, 9, 10, 11, 12, 13, 6, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 14, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 15, 16, 17, 41, 18, 42,
    19, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59]
_C.DATASETS.FS_TRAIN = ()
_C.DATASETS.SUBSET = False
_C.DATASETS.DT_PATH = ()

# ---------------------------------------------------------------------------
# DATALOADER (incl. LVC proposal/shot filters, lvc defaults.py:208-221)
# ---------------------------------------------------------------------------
_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 4
_C.DATALOADER.ASPECT_RATIO_GROUPING = True
_C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
_C.DATALOADER.REPEAT_THRESHOLD = 0.0
_C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True
_C.DATALOADER.PROPOSALS = CN()
_C.DATALOADER.PROPOSALS.AREA_RNG = [0.0, 1.0e10]
_C.DATALOADER.PROPOSALS.REL_AREA_RNG = [0.0, 2.0]
_C.DATALOADER.PROPOSALS.X_RNG = [0.0, 1.0e10]
_C.DATALOADER.PROPOSALS.Y_RNG = [0.0, 1.0e10]
_C.DATALOADER.PROPOSALS.TOPK = 1000
_C.DATALOADER.PROPOSALS.IOU_THRESH = 0.3
_C.DATALOADER.SHOTS = CN()
_C.DATALOADER.SHOTS.AREA_RNG = [0.0, 1.0e10]
_C.DATALOADER.SHOTS.REL_AREA_RNG = [0.0, 2.0]
_C.DATALOADER.SHOTS.X_RNG = [0.0, 1.0e10]
_C.DATALOADER.SHOTS.Y_RNG = [0.0, 1.0e10]
_C.DATALOADER.SHOTS.LONGEST_SIDE_ONLY = False

# ---------------------------------------------------------------------------
# Backbone / FPN / ResNet
# ---------------------------------------------------------------------------
_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.NAME = "build_resnet_fpn_backbone"
_C.MODEL.BACKBONE.FREEZE_AT = 2
_C.MODEL.BACKBONE.FREEZE = False
_C.MODEL.BACKBONE.FREEZE_BOTTOM_UP = False
# rematerialize backbone blocks on backward (TPU addition: trades FLOPs
# for HBM so larger train batches fit per chip)
_C.MODEL.BACKBONE.REMAT = True
_C.MODEL.BACKBONE.ANTI_ALIAS = False

_C.MODEL.FPN = CN()
_C.MODEL.FPN.IN_FEATURES = []
_C.MODEL.FPN.OUT_CHANNELS = 256
_C.MODEL.FPN.NORM = ""
_C.MODEL.FPN.FUSE_TYPE = "sum"

_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.DEPTH = 50
_C.MODEL.RESNETS.OUT_FEATURES = ["res4"]
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.NORM = "FrozenBN"
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True
_C.MODEL.RESNETS.RES5_DILATION = 1
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
_C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
_C.MODEL.RESNETS.DEFORM_MODULATED = False
_C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1
_C.MODEL.RESNETS.DEFORM_INTERVAL = 1
_C.MODEL.RESNETS.D = False
_C.MODEL.RESNETS.DROPOUT = 0.0

# ---------------------------------------------------------------------------
# Proposal generator / anchors / RPN
# ---------------------------------------------------------------------------
_C.MODEL.PROPOSAL_GENERATOR = CN()
_C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
_C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0
_C.MODEL.PROPOSAL_GENERATOR.FREEZE = False
_C.MODEL.PROPOSAL_GENERATOR.UNFREEZE_FIN = False

_C.MODEL.ANCHOR_GENERATOR = CN()
_C.MODEL.ANCHOR_GENERATOR.NAME = "DefaultAnchorGenerator"
_C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
_C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
_C.MODEL.ANCHOR_GENERATOR.ANGLES = [[-90, 0, 90]]
_C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

_C.MODEL.RPN = CN()
_C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
_C.MODEL.RPN.IN_FEATURES = ["res4"]
_C.MODEL.RPN.BOUNDARY_THRESH = -1
_C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
_C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
_C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.RPN.POSITIVE_FRACTION = 0.5
_C.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
_C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0
_C.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
_C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
_C.MODEL.RPN.LOSS_WEIGHT = 1.0
_C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
_C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
_C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
_C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
_C.MODEL.RPN.NMS_THRESH = 0.7
# TPU serving: approximate per-level pre-NMS top-k (see rpn.py)
_C.MODEL.RPN.APPROX_TOPK = False

# Random Box Generator (UBBR proposal source; lvc defaults.py:101-104)
_C.MODEL.RBG = CN()
_C.MODEL.RBG.ALPHA = 0.35
_C.MODEL.RBG.BETA = 0.5
_C.MODEL.RBG.T = 0.3

# ---------------------------------------------------------------------------
# Semantic segmentation / Panoptic FPN (vendored d2 meta-archs)
# ---------------------------------------------------------------------------
_C.MODEL.SEM_SEG_HEAD = CN()
_C.MODEL.SEM_SEG_HEAD.NAME = "SemSegFPNHead"
_C.MODEL.SEM_SEG_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5"]
_C.MODEL.SEM_SEG_HEAD.IGNORE_VALUE = 255
_C.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 54
_C.MODEL.SEM_SEG_HEAD.CONVS_DIM = 128
_C.MODEL.SEM_SEG_HEAD.COMMON_STRIDE = 4
_C.MODEL.SEM_SEG_HEAD.NORM = "GN"
_C.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 1.0

_C.MODEL.PANOPTIC_FPN = CN()
_C.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT = 1.0
_C.MODEL.PANOPTIC_FPN.COMBINE = CN()
_C.MODEL.PANOPTIC_FPN.COMBINE.ENABLED = True
_C.MODEL.PANOPTIC_FPN.COMBINE.OVERLAP_THRESH = 0.5
_C.MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT = 4096
_C.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.5

# ---------------------------------------------------------------------------
# RetinaNet (vendored d2 meta-arch; d2 defaults.py:419-454)
# ---------------------------------------------------------------------------
_C.MODEL.RETINANET = CN()
_C.MODEL.RETINANET.NUM_CLASSES = 80
_C.MODEL.RETINANET.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
_C.MODEL.RETINANET.NUM_CONVS = 4
_C.MODEL.RETINANET.IOU_THRESHOLDS = [0.4, 0.5]
_C.MODEL.RETINANET.IOU_LABELS = [0, -1, 1]
_C.MODEL.RETINANET.PRIOR_PROB = 0.01
_C.MODEL.RETINANET.SCORE_THRESH_TEST = 0.05
_C.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 1000
_C.MODEL.RETINANET.NMS_THRESH_TEST = 0.5
_C.MODEL.RETINANET.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
_C.MODEL.RETINANET.FOCAL_LOSS_GAMMA = 2.0
_C.MODEL.RETINANET.FOCAL_LOSS_ALPHA = 0.25
_C.MODEL.RETINANET.SMOOTH_L1_LOSS_BETA = 0.1

# ---------------------------------------------------------------------------
# ROI heads
# ---------------------------------------------------------------------------
_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
_C.MODEL.ROI_HEADS.NUM_CLASSES = 80
_C.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
_C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
_C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
_C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
_C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True
_C.MODEL.ROI_HEADS.FREEZE_FEAT = False
_C.MODEL.ROI_HEADS.REG_OFF = False
_C.MODEL.ROI_HEADS.FREEZE_BBOX_PRED = False
_C.MODEL.ROI_HEADS.IGNORE_REG = False
# RoIAlign implementation: "auto" (pallas on TPU inference, exact gather
# elsewhere) | "pallas" (paired-DMA, reference-exact) | "pallas_fast"
# (band-DMA serving mode; large/high-AR boxes pool one level coarser) |
# "tiled" | "exact"
_C.MODEL.ROI_HEADS.POOLER_IMPL = "auto"
# TFA/LVC output layer selection + cosine scale (lvc defaults.py:95-97)
_C.MODEL.ROI_HEADS.OUTPUT_LAYER = "FastRCNNOutputLayers"
_C.MODEL.ROI_HEADS.COSINE_SCALE = 20.0

_C.MODEL.ROI_BOX_HEAD = CN()
_C.MODEL.ROI_BOX_HEAD.NAME = ""
_C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
_C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0
_C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
_C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
# ours-only: static cap on the adaptive RoIAlign sampling grid (the
# reference's ceil(bin) rule is unbounded; TPU shapes must be static).
# Default 2: the Pallas serving kernels clamp to 2 regardless (VMEM
# scratch budget), so a larger default only slows the exact/tiled
# XLA-gather path (CPU tests, multichip dryrun) ~4x for zero TPU benefit.
# Set 4 to make the exact-gather path reference-exact for every
# FPN-assigned box except near-image-sized ones (the parity tests do).
# Grid-2 deviation quantified in PARITY.md: serving score |delta| max
# 4.4e-4; TRAINING gradients through the pooler carry the same grid-2
# cap on TPU regardless of this key (the Pallas kernels size VMEM for
# grid<=2), so grid 4 only changes the CPU exact-gather path — the
# train-path grad deviation grid-2-vs-4 is quantified in PARITY.md
# ("Pooler grid and training gradients").
_C.MODEL.ROI_BOX_HEAD.POOLER_MAX_GRID = 2

# Mask head (d2 defaults.py MODEL.ROI_MASK_HEAD; wired via MODEL.MASK_ON)
_C.MODEL.ROI_MASK_HEAD = CN()
_C.MODEL.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
_C.MODEL.ROI_MASK_HEAD.NUM_CONV = 4
_C.MODEL.ROI_MASK_HEAD.CONV_DIM = 256
_C.MODEL.ROI_MASK_HEAD.NORM = ""
_C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = False

# Keypoint head (d2 defaults.py MODEL.ROI_KEYPOINT_HEAD; MODEL.KEYPOINT_ON)
_C.MODEL.ROI_KEYPOINT_HEAD = CN()
_C.MODEL.ROI_KEYPOINT_HEAD.NAME = "KRCNNConvDeconvUpsampleHead"
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_CONV = 8
_C.MODEL.ROI_KEYPOINT_HEAD.CONV_DIM = 512
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
_C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
_C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
_C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
_C.MODEL.ROI_BOX_HEAD.NORM = ""
_C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
_C.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False
_C.MODEL.ROI_BOX_HEAD.DROPOUT = 0.0

_C.MODEL.ROI_BOX_CASCADE_HEAD = CN()
_C.MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS = (
    (10.0, 10.0, 5.0, 5.0),
    (20.0, 20.0, 10.0, 10.0),
    (30.0, 30.0, 15.0, 15.0),
)
_C.MODEL.ROI_BOX_CASCADE_HEAD.IOUS = (0.5, 0.6, 0.7)

# UBBR box corrector (lvc defaults.py:79-81)
_C.MODEL.UBBR = CN()
_C.MODEL.UBBR.LAMBDA = 0.6
_C.MODEL.UBBR.CASCADE_STEPS = 3

_C.MODEL.RPNCOMP = CN()
_C.MODEL.RPNCOMP.POOLER = ""

# Swin backbone (lvc defaults.py:109-124) — alternative backbone
_C.MODEL.SWIN = CN()
_C.MODEL.SWIN.PRETRAIN_IMG_SIZE = 224
_C.MODEL.SWIN.PATCH_SIZE = 4
_C.MODEL.SWIN.SWIN_SIZE = "tiny"
_C.MODEL.SWIN.WINDOW_SIZE = 7
_C.MODEL.SWIN.MLP_RATIO = 4.0
_C.MODEL.SWIN.QKV_BIAS = True
_C.MODEL.SWIN.QK_SCALE = None
_C.MODEL.SWIN.DROP_RATE = 0.0
_C.MODEL.SWIN.ATTN_DROP_RATE = 0.0
_C.MODEL.SWIN.DROP_PATH_RATE = 0.2
_C.MODEL.SWIN.NORM_LAYER = "LayerNorm"
_C.MODEL.SWIN.APE = False
_C.MODEL.SWIN.PATCH_NORM = True
_C.MODEL.SWIN.OUT_INDICES = (0, 1, 2, 3)
_C.MODEL.SWIN.FROZEN_STAGES = -1

# ---------------------------------------------------------------------------
# Query expansion (label verification knobs; lvc defaults.py:129-135)
# ---------------------------------------------------------------------------
_C.QUERY_EXPAND = CN()
_C.QUERY_EXPAND.GET_CROPS = False
_C.QUERY_EXPAND.ENABLED = False
_C.QUERY_EXPAND.NN_MODEL = ""
_C.QUERY_EXPAND.NN_DSET = ()
_C.QUERY_EXPAND.KNN = 10
_C.QUERY_EXPAND.COSINE_SIM = True

# ---------------------------------------------------------------------------
# SOLVER
# ---------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
_C.SOLVER.MAX_ITER = 40000
_C.SOLVER.BASE_LR = 0.001
_C.SOLVER.CLIP_LR = 0.001
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.NESTEROV = False
_C.SOLVER.WEIGHT_DECAY = 0.0001
_C.SOLVER.WEIGHT_DECAY_NORM = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
_C.SOLVER.WARMUP_ITERS = 1000
_C.SOLVER.WARMUP_METHOD = "linear"
# mixed-precision training: f32 master weights + bf16 compute
_C.SOLVER.AMP = CN()
_C.SOLVER.AMP.ENABLED = False
_C.SOLVER.CHECKPOINT_PERIOD = 5000
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.REFERENCE_WORLD_SIZE = 0
_C.SOLVER.BIAS_LR_FACTOR = 1.0
_C.SOLVER.WEIGHT_DECAY_BIAS = 0.0001
_C.SOLVER.CLIP_GRADIENTS = CN({"ENABLED": False})
_C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
_C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
_C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0

# ---------------------------------------------------------------------------
# TEST
# ---------------------------------------------------------------------------
_C.TEST = CN()
_C.TEST.EXPECTED_RESULTS = []
_C.TEST.EVAL_PERIOD = 0
_C.TEST.DETECTIONS_PER_IMAGE = 100
_C.TEST.AUG = CN({"ENABLED": False})
_C.TEST.AUG.MIN_SIZES = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
_C.TEST.AUG.MAX_SIZE = 4000
_C.TEST.AUG.FLIP = True
_C.TEST.PRECISE_BN = CN({"ENABLED": False})
_C.TEST.PRECISE_BN.NUM_ITER = 200

# ---------------------------------------------------------------------------
# TPU-only: static padding budgets (replaces the reference's dynamic shapes)
# ---------------------------------------------------------------------------
_C.PAD = CN()
_C.PAD.MAX_GT_PER_IMAGE = 100       # gt boxes padded to this count
_C.PAD.MAX_PROPOSALS_TRAIN = 2048   # proposals fed into roi heads (train)
_C.PAD.MAX_PROPOSALS_TEST = 1024
# image canvas buckets (h, w); the mapper picks the smallest fitting one so
# jit sees a handful of static shapes instead of one per image
_C.PAD.CANVAS_BUCKETS = [[832, 1344], [1344, 832], [1344, 1344]]

# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------
_C.OUTPUT_DIR = "./output"
_C.SEED = -1
_C.CUDNN_BENCHMARK = False
_C.VIS_PERIOD = 0
_C.MUTE_HEADER = True
_C.GLOBAL = CN()
_C.GLOBAL.HACK = 1.0
