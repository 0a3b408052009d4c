"""Default configuration of the port: the default tree of
``wsovod_tpu/config/defaults.py`` (the subset of Detectron2's defaults that
WSOVOD's YAML files touch, plus the WSOVOD extensions), so the same configs
load unchanged, with four port defaults:

* ``MODEL.DEVICE = "cuda"``;
* ``TPU.DAN_FC1_QUANT = "none"`` and ``TPU.RPN_CONV_QUANT = "none"`` (the
  JAX package defaults both to its TPU-only int8 paths, which the port does
  not have);
* ``TPU.COMPUTE_DTYPE = "bfloat16"`` (parameters stay float32).

``check_supported`` refuses every key that asks for a path the port does not
have yet.
"""

from .config import CfgNode as CN


def get_cfg() -> CN:
    _C = CN()
    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1
    _C.VIS_PERIOD = 0
    _C.VIS_TEST = False
    _C.CUDNN_BENCHMARK = False

    # ------------------------------------------------------------- MODEL
    _C.MODEL = CN()
    _C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN_WSOVOD"
    _C.MODEL.DEVICE = "cuda"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.LOAD_PROPOSALS = False
    # BGR means matching the reference caffe-style pixel stats
    _C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

    _C.MODEL.BACKBONE = CN()
    _C.MODEL.BACKBONE.NAME = "build_wsl_resnet_backbone"
    _C.MODEL.BACKBONE.FREEZE_AT = 5

    _C.MODEL.RESNETS = CN()
    _C.MODEL.RESNETS.DEPTH = 18
    _C.MODEL.RESNETS.OUT_FEATURES = ["res5"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True
    _C.MODEL.RESNETS.RES5_DILATION = 2
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    _C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
    _C.MODEL.RESNETS.DEFORM_MODULATED = False
    _C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1

    _C.MODEL.VGG = CN()
    _C.MODEL.VGG.DEPTH = 16
    _C.MODEL.VGG.OUT_FEATURES = ["plain5"]
    _C.MODEL.VGG.CONV5_DILATION = 1

    _C.MODEL.SWIN = CN()
    _C.MODEL.SWIN.EMBED_DIM = 96
    _C.MODEL.SWIN.OUT_FEATURES = ["stage2", "stage3", "stage4", "stage5"]
    _C.MODEL.SWIN.DEPTHS = [2, 2, 6, 2]
    _C.MODEL.SWIN.NUM_HEADS = [3, 6, 12, 24]
    _C.MODEL.SWIN.WINDOW_SIZE = 7
    _C.MODEL.SWIN.MLP_RATIO = 4
    _C.MODEL.SWIN.DROP_PATH_RATE = 0.2
    _C.MODEL.SWIN.APE = False
    _C.MODEL.SWIN.PATH_NORM = True

    # d2 FPN keys consumed by build_swin_fpn_backbone (d2 defaults)
    _C.MODEL.FPN = CN()
    _C.MODEL.FPN.IN_FEATURES = ["stage2", "stage3", "stage4", "stage5"]
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.NORM = ""
    _C.MODEL.FPN.FUSE_TYPE = "sum"

    _C.MODEL.MRRP = CN()
    _C.MODEL.MRRP.MRRP_ON = False
    _C.MODEL.MRRP.NUM_BRANCH = 3
    _C.MODEL.MRRP.BRANCH_DILATIONS = [1, 2, 3]
    _C.MODEL.MRRP.MRRP_STAGE = "res4"
    _C.MODEL.MRRP.TEST_BRANCH_IDX = 1

    _C.MODEL.ANCHOR_GENERATOR = CN()
    _C.MODEL.ANCHOR_GENERATOR.NAME = "DefaultAnchorGenerator"
    _C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    _C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    _C.MODEL.ANCHOR_GENERATOR.ANGLES = [[-90, 0, 90]]
    _C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

    _C.MODEL.PROPOSAL_GENERATOR = CN()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "WSOVODRPN_V2"
    _C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

    _C.MODEL.RPN = CN()
    _C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
    _C.MODEL.RPN.IN_FEATURES = ["res5"]
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
    _C.MODEL.RPN.CONV_DIMS = [-1]
    _C.MODEL.RPN.SCORE_THRESH_TRAIN = 0.2
    _C.MODEL.RPN.SCORE_THRESH_TEST = 0.2
    _C.MODEL.RPN.TOPK_CANDIDATES_TRAIN = 2000
    _C.MODEL.RPN.TOPK_CANDIDATES_TEST = 1000

    _C.MODEL.ROI_HEADS = CN()
    _C.MODEL.ROI_HEADS.NAME = "WSOVODROIHeads"
    _C.MODEL.ROI_HEADS.NUM_CLASSES = 80
    _C.MODEL.ROI_HEADS.IN_FEATURES = ["res5"]
    _C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
    _C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
    _C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    _C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    _C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    _C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    _C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True

    _C.MODEL.ROI_BOX_HEAD = CN()
    _C.MODEL.ROI_BOX_HEAD.NAME = "DiscriminativeAdaptationNeck"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    _C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    _C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
    _C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    _C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_BOX_HEAD.NORM = ""
    _C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    _C.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False
    _C.MODEL.ROI_BOX_HEAD.DAN_DIM = [4096, 4096]

    _C.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY = CN()
    _C.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_PATH_TRAIN = ""
    _C.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_PATH_TEST = ""
    _C.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_DIM = 512
    _C.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.USE_BIAS = 0.0
    _C.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.NORM_WEIGHT = True
    _C.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.NORM_TEMP = 100.0
    _C.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.DATA_AWARE = False
    _C.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.PROTOTYPE_NUM = 5

    # ------------------------------------------------------------ WSOVOD
    _C.WSOVOD = CN()
    _C.WSOVOD.ITER_SIZE = 1
    _C.WSOVOD.CLS_AGNOSTIC_BBOX_KNOWN = False
    _C.WSOVOD.SAMPLING = CN()
    _C.WSOVOD.SAMPLING.SAMPLING_ON = False
    _C.WSOVOD.SAMPLING.IOU_THRESHOLDS = [[0.5], [0.5], [0.5], [0.5]]
    _C.WSOVOD.SAMPLING.IOU_LABELS = [[0, 1], [0, 1], [0, 1], [0, 1]]
    _C.WSOVOD.SAMPLING.BATCH_SIZE_PER_IMAGE = [4096, 4096, 4096, 4096]
    _C.WSOVOD.SAMPLING.POSITIVE_FRACTION = [1.0, 1.0, 1.0, 1.0]
    _C.WSOVOD.OBJECT_MINING = CN()
    _C.WSOVOD.OBJECT_MINING.WEIGHT = 1.0
    _C.WSOVOD.OBJECT_MINING.MEAN_LOSS = True
    _C.WSOVOD.INSTANCE_REFINEMENT = CN()
    _C.WSOVOD.INSTANCE_REFINEMENT.WEIGHT = 1.0
    _C.WSOVOD.INSTANCE_REFINEMENT.REFINE_NUM = 3
    _C.WSOVOD.INSTANCE_REFINEMENT.REFINE_REG = [False, False, False]
    _C.WSOVOD.INSTANCE_REFINEMENT.REFINE_MIST = False
    _C.WSOVOD.INSTANCE_REFINEMENT.CROSS_ENTROPY_WEIGHTED = True
    _C.WSOVOD.BBOX_REFINE = CN()
    _C.WSOVOD.BBOX_REFINE.ENABLE = False
    _C.WSOVOD.BBOX_REFINE.MODEL_TYPE = "vit_b"
    _C.WSOVOD.BBOX_REFINE.MODEL_CHECKPOINT = "tools/sam_checkpoints/sam_vit_b_01ec64.pth"
    # cap on SAM box prompts per image per refine call (the mined-pgt table
    # is padded to num_classes*top_k rows but only present classes are
    # valid); 0 = no cap
    _C.WSOVOD.BBOX_REFINE.MAX_BOXES = 32

    # ------------------------------------------------------------- INPUT
    _C.INPUT = CN()
    _C.INPUT.MIN_SIZE_TRAIN = (800,)
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 800
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.RANDOM_FLIP = "horizontal"
    _C.INPUT.CROP = CN()
    _C.INPUT.CROP.ENABLED = False
    _C.INPUT.CROP.TYPE = "relative_range"
    _C.INPUT.CROP.SIZE = [0.9, 0.9]
    _C.INPUT.FORMAT = "BGR"
    _C.INPUT.MASK_FORMAT = "polygon"

    # ---------------------------------------------------------- DATASETS
    _C.DATASETS = CN()
    _C.DATASETS.TRAIN = ()
    _C.DATASETS.TEST = ()
    _C.DATASETS.PROPOSAL_FILES_TRAIN = ()
    _C.DATASETS.PROPOSAL_FILES_TEST = ()
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000
    _C.DATASETS.MIXED_DATASETS = CN()
    _C.DATASETS.MIXED_DATASETS.NAMES = ["coco_2017_train"]
    _C.DATASETS.MIXED_DATASETS.WEIGHT_PATH_TRAINS = [
        "models/coco_text_embedding_single_prompt.pkl"
    ]
    _C.DATASETS.MIXED_DATASETS.NUM_CLASSES = [80]
    _C.DATASETS.MIXED_DATASETS.PROPOSAL_FILES = [""]
    _C.DATASETS.MIXED_DATASETS.RATIOS = [1]
    _C.DATASETS.MIXED_DATASETS.USE_CAS = [False]
    _C.DATASETS.MIXED_DATASETS.USE_RFS = [True]
    _C.DATASETS.MIXED_DATASETS.FILTER_EMPTY_ANNOTATIONS = [True]
    _C.DATASETS.MIXED_DATASETS.CAS_LAMBDA = 1.0
    _C.DATASETS.MIXED_DATASETS.REPEAT_THRESHOLD = 0.001

    # -------------------------------------------------------- DATALOADER
    _C.DATALOADER = CN()
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True
    _C.DATALOADER.CLASS_ASPECT_RATIO_GROUPING = False
    _C.DATALOADER.GROUP_WAIT = 5
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    _C.DATALOADER.REPEAT_THRESHOLD = 0.0
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    # ------------------------------------------------------------ SOLVER
    _C.SOLVER = CN()
    _C.SOLVER.OPTIMIZER = "SGD"
    _C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    _C.SOLVER.MAX_ITER = 40000
    _C.SOLVER.BASE_LR = 0.001
    _C.SOLVER.BASE_LR_END = 0.1
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.NESTEROV = False
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (30000,)
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.IMS_PER_BATCH_LIST = [4]
    _C.SOLVER.REFERENCE_WORLD_SIZE = 0
    _C.SOLVER.BIAS_LR_FACTOR = 1.0
    _C.SOLVER.WEIGHT_DECAY_BIAS = None
    _C.SOLVER.BACKBONE_MULTIPLIER = 1.0
    _C.SOLVER.CLIP_GRADIENTS = CN()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
    _C.SOLVER.AMP = CN()
    _C.SOLVER.AMP.ENABLED = False

    # -------------------------------------------------------------- TEST
    _C.TEST = CN()
    _C.TEST.EXPECTED_RESULTS = []
    _C.TEST.EVAL_PERIOD = 0
    _C.TEST.EVAL_TRAIN = False
    # route post-NMS proposals into eval outputs for the proposal-recall
    # AR@{100,1000} diagnostic + box_proposals.pkl dump
    _C.TEST.EVAL_PROPOSALS = False
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.AUG = CN()
    _C.TEST.AUG.ENABLED = False
    _C.TEST.AUG.MIN_SIZES = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
    _C.TEST.AUG.MAX_SIZE = 4000
    _C.TEST.AUG.FLIP = True
    _C.TEST.PRECISE_BN = CN()
    _C.TEST.PRECISE_BN.ENABLED = False
    _C.TEST.PRECISE_BN.NUM_ITER = 200

    # ------------------------------------------------------- TPU-specific
    # Keys of the JAX package's TPU paths, kept so that every YAML merges
    # into the same tree in both packages. The port reads COMPUTE_DTYPE and
    # refuses the int8 paths (check_supported); the others have no effect.
    _C.TPU = CN()
    _C.TPU.MESH_SHAPE = [-1]
    _C.TPU.MESH_AXES = ["data"]
    _C.TPU.IMAGE_SIZE_DIVISIBILITY = 32
    _C.TPU.IMAGE_BUCKETS = []
    _C.TPU.PROPOSAL_PAD = 4096
    _C.TPU.MAX_GT_PAD = 128
    _C.TPU.COMPUTE_DTYPE = "bfloat16"  # parameters stay float32
    _C.TPU.PARAM_DTYPE = "float32"
    _C.TPU.SAM_COMPUTE_DTYPE = "bfloat16"
    _C.TPU.ROI_ALIGN_KERNEL = "fused"
    # port default "none" (the JAX package defaults to its int8 fc1)
    _C.TPU.DAN_FC1_QUANT = "none"
    _C.TPU.UNFUSED_ROI_CHUNK = 512
    # port default "none" (the JAX package defaults to its int8 RPN conv)
    _C.TPU.RPN_CONV_QUANT = "none"
    _C.TPU.BACKBONE_CONV_QUANT = "none"

    return _C



def _refuse(key: str, value, why: str):
    raise NotImplementedError(
        f"{key}={value!r} is not ported to wsovod_torch yet ({why})"
    )


def check_supported(cfg: CN) -> None:
    """Raise ``NotImplementedError`` naming the first key that asks for a
    path the port does not have. Keys that only act during training (solver,
    sampling, mining, ``WSOVOD.BBOX_REFINE``) are checked by
    ``check_train_supported``: the reference ignores them at inference too.

    MRRP is ported for the WSR ResNet with the multi-branch stage at res5 and
    the ``ROILoopPool`` pooler, with all branches at test
    (``TEST_BRANCH_IDX = -1``) or one (``>= 0``). ``ROILoopPool`` also runs
    without MRRP; then each ROI pools from its own image."""
    m = cfg.MODEL
    mrrp = m.MRRP
    pooler = m.ROI_BOX_HEAD.POOLER_TYPE
    checks = [
        ("MODEL.META_ARCHITECTURE", m.META_ARCHITECTURE,
         m.META_ARCHITECTURE == "GeneralizedRCNN_WSOVOD", "mixed datasets"),
        ("MODEL.BACKBONE.NAME", m.BACKBONE.NAME,
         m.BACKBONE.NAME in ("build_wsl_resnet_backbone", "build_mrrp_wsl_resnet_backbone"),
         "VGG/Swin backbones"),
        ("MODEL.ROI_BOX_HEAD.POOLER_TYPE", pooler,
         pooler in ("ROIPool", "ROILoopPool"), "the ROIAlignV2 pooler"),
        ("MODEL.MRRP.MRRP_ON", mrrp.MRRP_ON,
         not mrrp.MRRP_ON or pooler == "ROILoopPool", "MRRP with a pooler other than ROILoopPool"),
        ("MODEL.MRRP.MRRP_STAGE", mrrp.MRRP_STAGE,
         not mrrp.MRRP_ON or mrrp.MRRP_STAGE == "res5", "MRRP stages other than res5"),
        ("MODEL.MRRP.BRANCH_DILATIONS", list(mrrp.BRANCH_DILATIONS),
         not mrrp.MRRP_ON or len(mrrp.BRANCH_DILATIONS) == mrrp.NUM_BRANCH,
         "one dilation per branch"),
        ("MODEL.MRRP.TEST_BRANCH_IDX", mrrp.TEST_BRANCH_IDX,
         not mrrp.MRRP_ON or -1 <= mrrp.TEST_BRANCH_IDX < mrrp.NUM_BRANCH,
         "-1 (all branches) or a branch index"),
        ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", list(m.RESNETS.DEFORM_ON_PER_STAGE),
         not any(m.RESNETS.DEFORM_ON_PER_STAGE), "deformable convs"),
        ("MODEL.RESNETS.NORM", m.RESNETS.NORM,
         m.RESNETS.NORM in ("FrozenBN", "BN", "SyncBN"), "norms other than frozen BN"),
        ("MODEL.PROPOSAL_GENERATOR.NAME", m.PROPOSAL_GENERATOR.NAME,
         m.PROPOSAL_GENERATOR.NAME == "WSOVODRPN_V2", "other proposal generators"),
        ("MODEL.RPN.HEAD_NAME", m.RPN.HEAD_NAME,
         m.RPN.HEAD_NAME == "StandardRPNHead", "other RPN heads"),
        ("MODEL.RPN.IN_FEATURES", list(m.RPN.IN_FEATURES),
         len(m.RPN.IN_FEATURES) == 1, "multi-level RPN"),
        ("MODEL.ROI_HEADS.NAME", m.ROI_HEADS.NAME,
         m.ROI_HEADS.NAME == "WSOVODROIHeads", "other ROI heads"),
        ("MODEL.ROI_HEADS.IN_FEATURES", list(m.ROI_HEADS.IN_FEATURES),
         len(m.ROI_HEADS.IN_FEATURES) == 1, "multi-level pooling"),
        ("MODEL.ROI_BOX_HEAD.NAME", m.ROI_BOX_HEAD.NAME,
         m.ROI_BOX_HEAD.NAME == "DiscriminativeAdaptationNeck", "other box heads"),
        ("MODEL.ROI_BOX_HEAD.NUM_CONV", m.ROI_BOX_HEAD.NUM_CONV,
         m.ROI_BOX_HEAD.NUM_CONV == 0, "DAN convs"),
        ("MODEL.ROI_BOX_HEAD.DAN_DIM", list(m.ROI_BOX_HEAD.DAN_DIM),
         len(m.ROI_BOX_HEAD.DAN_DIM) == 2, "DANs other than fc1 + fc2"),
        ("MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_PATH_TRAIN",
         m.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_PATH_TRAIN,
         m.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_PATH_TRAIN != "rand",
         "learned random class weights"),
        ("MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.USE_BIAS",
         m.ROI_BOX_HEAD.OPEN_VOCABULARY.USE_BIAS,
         abs(m.ROI_BOX_HEAD.OPEN_VOCABULARY.USE_BIAS) <= 1e-9, "classifier bias"),
        ("TPU.DAN_FC1_QUANT", cfg.TPU.DAN_FC1_QUANT,
         cfg.TPU.DAN_FC1_QUANT == "none", "int8 fc1"),
        ("TPU.RPN_CONV_QUANT", cfg.TPU.RPN_CONV_QUANT,
         cfg.TPU.RPN_CONV_QUANT == "none", "int8 RPN conv"),
        ("TPU.BACKBONE_CONV_QUANT", cfg.TPU.BACKBONE_CONV_QUANT,
         cfg.TPU.BACKBONE_CONV_QUANT == "none", "int8 backbone convs"),
        ("TPU.COMPUTE_DTYPE", cfg.TPU.COMPUTE_DTYPE,
         cfg.TPU.COMPUTE_DTYPE in ("bfloat16", "float32"), "other compute dtypes"),
        ("TEST.AUG.ENABLED", cfg.TEST.AUG.ENABLED, not cfg.TEST.AUG.ENABLED,
         "test-time augmentation"),
        ("TEST.EVAL_PROPOSALS", cfg.TEST.EVAL_PROPOSALS,
         not cfg.TEST.EVAL_PROPOSALS, "proposal-recall evaluation"),
    ]
    for key, value, ok, why in checks:
        if not ok:
            _refuse(key, value, why)


def check_train_supported(cfg: CN) -> None:
    """``check_supported`` plus the keys that only act during training:
    raise ``NotImplementedError`` naming the first one that asks for a path
    the port's trainer does not have. Training is ported for every detector
    ``check_supported`` admits: plain with ``ROIPool`` or ``ROILoopPool``,
    MRRP at res5 with ``ROILoopPool``. ``WSOVOD.BBOX_REFINE`` is the
    trainer's to handle (``engine/trainer.py``)."""
    check_supported(cfg)
    m = cfg.MODEL
    ir = cfg.WSOVOD.INSTANCE_REFINEMENT
    checks = [
        ("WSOVOD.INSTANCE_REFINEMENT.REFINE_MIST", ir.REFINE_MIST, not ir.REFINE_MIST,
         "MIST mining"),
        ("MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE", m.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE,
         m.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE in ("smooth_l1", "smooth_l1_weighted"),
         "IoU box losses"),
        ("SOLVER.OPTIMIZER", cfg.SOLVER.OPTIMIZER, cfg.SOLVER.OPTIMIZER.upper() == "SGD",
         "optimizers other than SGD"),
        ("SOLVER.LR_SCHEDULER_NAME", cfg.SOLVER.LR_SCHEDULER_NAME,
         cfg.SOLVER.LR_SCHEDULER_NAME == "WarmupMultiStepLR", "other LR schedules"),
    ]
    for key, value, ok, why in checks:
        if not ok:
            _refuse(key, value, why)
