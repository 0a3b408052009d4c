"""Shared set-up of the ``test_torch_*`` parity tests: the tiny golden
config (read from the repo's ``configs/``), seeded numpy inputs, and the JAX
reference model with its parameters, built once per process."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

# The suite runs in several worker processes (pytest-xdist); at these tiny
# shapes torch's intra-op threads in every worker only contend for the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(REPO, "configs", "COCO-Detection", "WSOVOD_WSR_18_DC5_1x.yaml")
MRRP_YAML = os.path.join(REPO, "configs", "COCO-Detection", "WSOVOD_MRRP_WSR_18_DC5_1x.yaml")
VGG_YAML = os.path.join(REPO, "configs", "COCO-Detection", "WSOVOD_V_16_DC5_1x.yaml")
MRRP_VGG_YAML = os.path.join(REPO, "configs", "COCO-Detection", "WSOVOD_MRRP_V_16_DC5_1x.yaml")
NUM_CLASSES = 5
WEIGHT_DIM = 16


def tiny_cfg(cfg, yaml: str = TINY_YAML, test_branch_idx=None, pooler=None):
    """The golden-forward overrides (``tests/test_golden_forward.py``) on
    an R18 DC5 config (default the plain one; ``MRRP_YAML`` for MRRP, with
    ``test_branch_idx`` if given) or a VGG16 one (``VGG_YAML``,
    ``MRRP_VGG_YAML``; their RPN reads ``plain5``, which the YAMLs leave at
    the base's ``res5``), float32, no int8, no TTA; ``pooler`` sets
    ``POOLER_TYPE``."""
    cfg.merge_from_file(yaml)
    if "vgg" in cfg.MODEL.BACKBONE.NAME:
        cfg.MODEL.RPN.IN_FEATURES = ["plain5"]
    if test_branch_idx is not None:
        cfg.MODEL.MRRP.TEST_BRANCH_IDX = test_branch_idx
    if pooler is not None:
        cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE = pooler
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = NUM_CLASSES
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 16
    cfg.MODEL.ROI_BOX_HEAD.DAN_DIM = [64, 64]
    cfg.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_DIM = WEIGHT_DIM
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DAN_FC1_QUANT = "none"
    cfg.TPU.RPN_CONV_QUANT = "none"
    cfg.TEST.AUG.ENABLED = False
    return cfg


def make_batch(seed: int = 0, b: int = 2, s: int = 12, size: int = 64, gt: bool = False):
    """Synthetic images and SAM proposals (``tests/test_golden_forward.py``
    recipe), numpy; with ``gt``, also the image-level supervision
    ``gt_classes``/``gt_valid [B, 4]`` (1 to 4 valid instances per image)."""
    rng = np.random.RandomState(seed)
    boxes = rng.uniform(0, size * 0.6, (b, s, 2))
    boxes = np.concatenate([boxes, boxes + rng.uniform(8, 20, (b, s, 2))], -1)
    batch = {
        "images": rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32),
        "image_sizes": np.array([[size, size]] * b, np.int32),
        "sam_boxes": boxes.astype(np.float32),
        "sam_scores": rng.uniform(0.5, 1, (b, s)).astype(np.float32),
        "sam_valid": np.ones((b, s), bool),
    }
    if gt:
        batch["gt_classes"] = rng.randint(0, NUM_CLASSES, (b, 4)).astype(np.int32)
        batch["gt_valid"] = np.arange(4)[None, :] < rng.randint(1, 5, (b, 1))
    return batch


def routed_pool_inputs(seed=0, b=2, n_br=3, h=9, w=13, c=12, n=40, scale=0.125):
    """Features of ``n_br`` branch copies (branch-major), boxes from the
    image-scale mix plus hand-made rows, the ``(objectness+1)*valid`` gate
    and each ROI's source copy ``branch * b + image``."""
    rng = np.random.RandomState(seed)
    img_w, img_h = w / scale, h / scale
    feat = rng.randn(n_br * b, h, w, c).astype(np.float32)
    xy = rng.uniform(-20, img_w * 0.8, (b, n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, img_w * 0.7, (b, n, 2))], -1)
    rois[:, 0] = [img_w - 30, img_h - 20, img_w + 60, img_h + 50]  # overhangs right/bottom
    rois[:, 1] = [-50, -40, 40, 30]  # overhangs left/top: the context's hole exceeds the outer box
    rois[:, 2] = [50, 40, 20, 10]  # degenerate: x2 < x1, y2 < y1
    rois[:, 3] = [4, 12, 100, 60]  # ROI region on .5 boundaries
    rois[:, 4] = [4, 20, 40, 60]  # inner box x1 = 12 on a .5 boundary
    rois[:, 5] = [20, 28, 60, 68]  # outer box on .5 boundaries (x1 = 4, x2 = 76)
    rois[:, 6] = [0, 0, img_w, img_h]  # the whole image
    rois[:, 7] = [30, 30, 31, 31]  # one pixel, the inner hole empty
    rois[:, 8] = [-400, -300, -200, -100]  # wholly outside
    valid = rng.rand(b, n) > 0.15
    valid[:, :9] = True
    valid[:, 9] = False
    gate = ((rng.rand(b, n) + 1.0) * valid).astype(np.float32)
    rois = np.where(valid[..., None], rois, 0.0).astype(np.float32)
    branch = rng.randint(0, n_br, (b, n))
    branch[:, :n_br] = np.arange(n_br)  # every branch is read
    src = (branch * b + np.arange(b)[:, None]).astype(np.int32)
    return feat, rois, gate, src


def embeddings() -> np.ndarray:
    return np.random.RandomState(1).randn(NUM_CLASSES, WEIGHT_DIM).astype(np.float32)


def random_params(shapes, seed: int = 0):
    """Seeded numpy parameters for a JAX parameter-shape tree (from
    ``jax.eval_shape`` of ``init``, so no init program is compiled), at the
    scales of the JAX package's initialisers, so proposals and scores stay
    in a useful range: backbone kernels N(0, 1/fan_in) with random frozen-BN
    statistics (scale U(0.2, 0.6) keeps activations O(1)), RPN N(0, 0.01),
    DAN N(0, 0.005) with bias about 0.1, classifier projections
    N(0, 1/fan_in), box regressor N(0, 0.001), data-aware linears
    U(0, 0.02), prototypes N(0, 1). Biases get small random values so no
    two units tie."""
    import jax

    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        kernel = name.endswith("['kernel']")
        if "FrozenBatchNorm" in name:
            if name.endswith("['var']"):
                v = rng.uniform(0.5, 2.0, shape)
            elif name.endswith("['scale']"):
                v = rng.uniform(0.2, 0.6, shape)
            else:
                v = rng.randn(*shape) * 0.1
        elif name.endswith("['datasets_feat']"):
            v = rng.randn(*shape)
        elif "rpn_head" in name:
            v = rng.randn(*shape) * (0.01 if kernel else 0.001)
        elif "box_head" in name:
            v = rng.randn(*shape) * 0.005 if kernel else 0.1 + rng.randn(*shape) * 0.01
        elif "bbox_pred" in name:
            v = rng.randn(*shape) * 0.001
        elif "linear" in name and kernel:
            v = rng.uniform(0.0, 0.02, shape)
        elif kernel:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = rng.randn(*shape) * 0.01
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def jax_reference(yaml: str = TINY_YAML, test_branch_idx=None, pooler=None):
    """``(model, params)`` of the JAX package on the tiny config (``yaml``,
    ``test_branch_idx`` and ``pooler`` as ``tiny_cfg``), with
    ``random_params`` on the parameter tree of a training-mode ``init``
    (the object miner's parameters exist only there; they come last, so the
    other leaves' draws are those of the inference tree). The test branch
    index and the pooler own no parameters (the trees are the same): with
    either given, the parameters are those of ``jax_reference(yaml)``."""
    import jax
    import jax.numpy as jnp

    from wsovod_tpu.config import get_cfg
    from wsovod_tpu.models import build_model

    model = build_model(tiny_cfg(get_cfg(), yaml, test_branch_idx, pooler))
    if test_branch_idx is not None or pooler is not None:
        return model, jax_reference(yaml)[1]
    # the parameter shapes do not depend on the batch: trace the smallest
    batch = {k: jnp.asarray(v) for k, v in make_batch(b=1, s=2, size=32, gt=True).items()}
    emb = jnp.asarray(embeddings())
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                           batch, train=True, iteration=jnp.asarray(1),
                           rng=jax.random.PRNGKey(2), embeddings=emb)
    )
    return model, random_params(shapes)


@functools.lru_cache(maxsize=None)
def jax_stages(seed: int, yaml: str = TINY_YAML, test_branch_idx=None, pooler=None):
    """The JAX model (``jax_reference(yaml, test_branch_idx, pooler)``) on
    ``make_batch(seed)``, as numpy: ``(features, rpn proposals, data-aware
    vector, forward)`` where ``forward`` is ``model.apply(..., train=False,
    return_proposals=True)``'s ``(det, probs, boxes, (proposal_boxes,
    objectness, valid))``. One compiled program per config serves every
    seed."""
    import jax
    import jax.numpy as jnp

    model, params = jax_reference(yaml, test_branch_idx, pooler)
    batch = {k: jnp.asarray(v) for k, v in make_batch(seed).items()}
    return jax.tree_util.tree_map(np.array,
                                  _jax_stage_fn(yaml, test_branch_idx, pooler)(params, batch))


@functools.lru_cache(maxsize=None)
def _jax_stage_fn(yaml: str, test_branch_idx, pooler):
    import jax
    import jax.numpy as jnp

    model, _ = jax_reference(yaml, test_branch_idx, pooler)
    emb = jnp.asarray(embeddings())

    def stages(m, b):
        forward = m(b, train=False, embeddings=emb, return_proposals=True)
        feats = m.backbone(m._normalize(b["images"]))
        rpn, _ = m.proposal_generator(feats, b["image_sizes"])
        # the data-aware vector as GeneralizedRCNN_WSOVOD.__call__ makes it
        f = feats[m.in_feature]
        s = b["image_sizes"] // (b["images"].shape[1] // f.shape[1])
        pixel_valid = (jnp.arange(f.shape[1])[None, :, None] < s[:, 0, None, None]) & (
            jnp.arange(f.shape[2])[None, None, :] < s[:, 1, None, None])
        daf = m.data_aware_head(f, pixel_valid=pixel_valid)
        return feats, rpn, daf, forward

    return jax.jit(lambda p, b: model.apply(p, b, method=stages))


def torch_model_from_jax(yaml: str = TINY_YAML, test_branch_idx=None, pooler=None):
    """The port's model on the CPU with the JAX reference's parameters."""
    from wsovod_torch import get_cfg
    from wsovod_torch.models import build_model
    from wsovod_torch.utils.weight_import import state_dict_from_jax

    _, params = jax_reference(yaml)
    model = build_model(tiny_cfg(get_cfg(), yaml, test_branch_idx, pooler), device="cpu",
                        seed=None)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model
