"""Shared set-up of the ``test_torch_*`` parity tests: the tiny golden
config (read from the repo's ``configs/``), seeded numpy inputs, and the JAX
reference model with its parameters, built once per process."""

from __future__ import annotations

import contextlib
import fcntl
import functools
import hashlib
import os
import pickle
import tempfile

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
# the Swin-T FPN detector's config, the port's own (chip_smoke.py reads it too)
SWIN_YAML = os.path.join(REPO, "wsovod_torch", "config", "swin_t_fpn.yaml")
SWIN_SIZE = 160  # the tiny Swin FPN's images: large SAM boxes fall on p3
NUM_CLASSES = 5
WEIGHT_DIM = 16


def tiny_cfg(cfg, yaml: str = TINY_YAML, test_branch_idx=None, pooler=None, quant="none"):
    """The golden-forward overrides (``tests/test_golden_forward.py``) on
    an R18 DC5 config (default the plain one; ``MRRP_YAML`` for MRRP, with
    ``test_branch_idx`` if given) or a VGG16 one (``VGG_YAML``,
    ``MRRP_VGG_YAML``; their RPN reads ``plain5``, which the YAMLs leave at
    the base's ``res5``), float32, no TTA; ``pooler`` sets ``POOLER_TYPE``,
    ``quant`` both ``TPU.DAN_FC1_QUANT`` and ``TPU.RPN_CONV_QUANT`` (default
    no int8). ``SWIN_YAML``: the Swin-T FPN cut to a tiny Swin (embed 24,
    depths ``[2, 2, 1, 1]``, 2 heads, window 4, so every stage runs a
    shifted block or pads its windows) under a 32-channel FPN."""
    cfg.merge_from_file(yaml)
    if "swin" in cfg.MODEL.BACKBONE.NAME:
        cfg.MODEL.SWIN.EMBED_DIM = 24
        cfg.MODEL.SWIN.DEPTHS = [2, 2, 1, 1]
        cfg.MODEL.SWIN.NUM_HEADS = [2, 2, 2, 2]
        cfg.MODEL.SWIN.WINDOW_SIZE = 4
        cfg.MODEL.FPN.OUT_CHANNELS = 32
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
    cfg.TPU.DAN_FC1_QUANT = quant
    cfg.TPU.RPN_CONV_QUANT = quant
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


def batch_for(yaml: str, seed: int) -> dict:
    """The test batch of a config: ``make_batch(seed)``, or for ``SWIN_YAML``
    ``SWIN_SIZE`` images whose first four SAM boxes per image have sides of
    112 px or more, so that the ROIs fall on two FPN levels."""
    if yaml != SWIN_YAML:
        return make_batch(seed)
    batch = make_batch(seed, size=SWIN_SIZE)
    batch["sam_boxes"][:, :4] = [[4, 6, 150, 140], [20, 10, 140, 125], [0, 0, 160, 160],
                                 [30, 40, 150, 158]]
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
    U(0, 0.02), prototypes N(0, 1), LayerNorm scales U(0.5, 1.5), relative
    position bias tables N(0, 1). Biases get small random values so no
    two units tie."""
    import jax

    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        kernel = name.endswith("['kernel']")
        if "relative_position_bias_table" in name:  # large enough to reorder attention
            v = rng.randn(*shape)
        elif name.endswith("['scale']") and "FrozenBatchNorm" not in name:  # LayerNorm
            v = rng.uniform(0.5, 1.5, shape)
        elif "FrozenBatchNorm" in name:
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


def jax_reference(yaml: str = TINY_YAML, test_branch_idx=None, pooler=None, quant="none"):
    """``(model, params)`` of the JAX package on the tiny config (``yaml``,
    ``test_branch_idx``, ``pooler`` and ``quant`` as ``tiny_cfg``), with
    ``random_params`` on the parameter tree of a training-mode ``init``
    (the object miner's parameters exist only there; they come last, so the
    other leaves' draws are those of the inference tree). The test branch
    index, the pooler and the quantization own no parameters (the trees are
    the same): with any given, the parameters are those of
    ``jax_reference(yaml)``. The JAX package's multi-level pooler cannot be
    traced (it takes ``int()`` of a ``jnp.log2`` of its scales), so the
    Swin FPN's parameter tree is traced on one pooled level: the pooler
    owns no parameters, and the tree is the same. Cached by the
    arguments' values, however they are passed: ``jax_reference()`` and
    ``jax_reference(TINY_YAML, None)`` trace the parameter tree once."""
    return _jax_reference(yaml, test_branch_idx, pooler, quant)


@functools.lru_cache(maxsize=None)
def _jax_reference(yaml: str, test_branch_idx, pooler, quant: str):
    import jax
    import jax.numpy as jnp

    from wsovod_tpu.config import get_cfg
    from wsovod_tpu.models import build_model

    model = build_model(tiny_cfg(get_cfg(), yaml, test_branch_idx, pooler, quant))
    if test_branch_idx is not None or pooler is not None or quant != "none":
        return model, jax_reference(yaml)[1]
    traced = model
    if yaml == SWIN_YAML:
        cfg = tiny_cfg(get_cfg(), yaml)
        cfg.MODEL.ROI_HEADS.IN_FEATURES = cfg.MODEL.ROI_HEADS.IN_FEATURES[:1]
        traced = build_model(cfg)

    def shapes():  # they do not depend on the batch: trace the smallest
        batch = {k: jnp.asarray(v) for k, v in make_batch(b=1, s=2, size=32, gt=True).items()}
        emb = jnp.asarray(embeddings())
        return jax.eval_shape(lambda: traced.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, batch,
            train=True, iteration=jnp.asarray(1), rng=jax.random.PRNGKey(2), embeddings=emb))

    return model, random_params(run_shared("jax_reference shapes", (yaml,), shapes))


def jax_stages(seed: int, yaml: str = TINY_YAML, test_branch_idx=None, pooler=None):
    """The JAX model (``jax_reference(yaml, test_branch_idx, pooler)``) on
    ``batch_for(yaml, seed)``, as numpy: ``(features, rpn proposals, data-aware
    vector, forward)`` where ``forward`` is ``model.apply(..., train=False,
    return_proposals=True)``'s ``(det, probs, boxes, (proposal_boxes,
    objectness, valid))``. One compiled program per config serves every
    seed (the Swin FPN's traced as ``jax_apply`` says). Cached by the
    arguments' values, however they are passed."""
    return _jax_stages(seed, yaml, test_branch_idx, pooler)


@functools.lru_cache(maxsize=None)
def _jax_stages(seed: int, yaml: str, test_branch_idx, pooler):
    import jax
    import jax.numpy as jnp

    def stages():
        _, params = jax_reference(yaml, test_branch_idx, pooler)
        batch = {k: jnp.asarray(v) for k, v in batch_for(yaml, seed).items()}
        return jax.tree_util.tree_map(np.array,
                                      _jax_stage_fn(yaml, test_branch_idx, pooler)(params, batch))

    return run_shared("jax_stages", (seed, yaml, test_branch_idx, pooler), stages)


def run_shared(kind: str, key: tuple, compute):
    """``compute()``, once per pytest-xdist run: its workers share the value
    through a file under the temporary directory, named by ``kind`` and
    ``key`` (a worker that needs a value another is computing waits for it,
    then reads it). Outside xdist, ``compute()``. The value must pickle.
    Nothing outlives the run's id: every run computes its values anew."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return compute()
    folder = os.path.join(tempfile.gettempdir(), f"wsovod_port_tests_{run}")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, hashlib.sha256(repr((kind, key)).encode()).hexdigest()[:24])
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        with open(path + ".tmp", "wb") as f:
            pickle.dump(value, f)
        os.replace(path + ".tmp", path)
        return value


@functools.lru_cache(maxsize=None)
def _jax_stage_fn(yaml: str, test_branch_idx, pooler):
    import jax
    import jax.numpy as jnp

    model, _ = jax_reference(yaml, test_branch_idx, pooler)
    emb = jnp.asarray(embeddings())

    def stages(p, b):
        return _forward_and_front(model, p, b, emb)

    return jax_apply(yaml, stages)


def jax_apply(yaml: str, fn):
    """``jax.jit(fn)``; for ``SWIN_YAML`` traced under
    ``concrete_pooler_scales``."""
    import jax

    jitted = jax.jit(fn)
    if yaml != SWIN_YAML:
        return jitted

    def run(*a):
        with concrete_pooler_scales():
            return jitted(*a)

    return run


@contextlib.contextmanager
def concrete_pooler_scales():
    """While active, the JAX package's ``ROIPooler.__call__`` runs under
    ``jax.ensure_compile_time_eval``: its multi-level path takes ``int()`` of
    a ``jnp.log2`` of its scales, which a trace does not allow (ROADMAP
    3.13); computed eagerly, that constant traces, and the pooler's code is
    the same. Undone on exit: nothing in the JAX package changes."""
    import jax

    from wsovod_tpu.models.poolers import ROIPooler

    call = ROIPooler.__dict__["__call__"]

    def concrete(self, *a, **k):
        with jax.ensure_compile_time_eval():
            return call(self, *a, **k)

    ROIPooler.__call__ = concrete
    try:
        yield
    finally:
        ROIPooler.__call__ = call


_FRONT = ("backbone", "proposal_generator", "data_aware_head")


def _forward_and_front(model, p, b, emb):
    """``(features, rpn proposals, data-aware vector, forward)`` of the JAX
    model on batch ``b``: ``forward`` is ``model.apply(..., train=False,
    return_proposals=True)``'s ``(det, probs, boxes, (proposal_boxes,
    objectness, valid))``, the other three the outputs of its backbone, RPN
    and data-aware head inside that forward (captured, not computed again)."""
    forward, state = model.apply(
        p, b, train=False, embeddings=emb, return_proposals=True,
        capture_intermediates=lambda mdl, method: (
            method == "__call__" and len(mdl.scope.path) == 1 and mdl.name in _FRONT),
        mutable=["intermediates"])
    seen = state["intermediates"]
    feats, (rpn, _), daf = (seen[name]["__call__"][0] for name in _FRONT)
    return feats, rpn, daf, forward


def torch_model_from_jax(yaml: str = TINY_YAML, test_branch_idx=None, pooler=None,
                         quant="none"):
    """The port's model on the CPU with the JAX reference's parameters."""
    from wsovod_torch import get_cfg
    from wsovod_torch.models import build_model
    from wsovod_torch.utils.weight_import import state_dict_from_jax

    _, params = jax_reference(yaml)
    model = build_model(tiny_cfg(get_cfg(), yaml, test_branch_idx, pooler, quant), device="cpu",
                        seed=None)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


@functools.lru_cache(maxsize=None)
def jax_int8_forward(yaml: str = TINY_YAML, routes=("default", "maxabs")):
    """The JAX package's int8 inference (``TPU.DAN_FC1_QUANT`` and
    ``TPU.RPN_CONV_QUANT`` ``"int8"``) of ``jax_reference(yaml)``'s
    parameters on ``make_batch(0)``, run as
    ``tests/test_golden_eval_int8.py`` runs it: ``ROIPooler._on_tpu``
    patched true and the fused pool kernels in Pallas interpret mode, so the
    pooler takes its TPU path (on the CPU it would pool unfused, and fc1
    would not be chunked, hence not int8), with one change of schedule: the
    pool kernel runs one ROI per grid step (``roi_block=1``, its 8-ROI
    source table repeated per ROI) instead of 8, which gives the same bits
    (the tiny plain and MRRP R18's probabilities, bit for bit) and traces
    in a quarter of the time. One traced program holds every
    route of ``routes``: ``"default"`` (the bf16 emission, fc1 quantizes)
    and ``"maxabs"`` (``WSOVOD_POOL_MAXABS=1``, the kernels' maxabs
    emission), the environment toggle set while that route is traced. The
    first route runs the whole forward; the others run its ROI heads alone
    on the first route's features, proposals (their ``level_ids`` the RPN's,
    the SAM rows' 0, as the forward fuses them at inference) and
    data-aware vector, since nothing before the ROI heads depends on the
    route.
    Returns numpy ``{"stages": (features, rpn proposals with the int8 RPN
    conv, data-aware vector), route: forward}``, ``forward`` as in
    ``jax_stages``. Nothing in the JAX package changes: the patch and the
    interpret flag are undone before this returns."""
    import jax
    import jax.numpy as jnp

    from wsovod_tpu.models.poolers import ROIPooler
    import wsovod_tpu.ops.pallas.roi_pool_fused as rpf

    model, params = jax_reference(yaml, quant="int8")
    emb = jnp.asarray(embeddings())
    batch = {k: jnp.asarray(v) for k, v in make_batch(0).items()}

    from wsovod_tpu.structures.instances import Instances as JaxInstances

    def heads(m, feats, props, sizes, daf, e):
        return m.roi_heads.inference(feats, props, sizes, data_aware_features=daf, embeddings=e)

    def routed(p, b):
        out = {}
        saved = os.environ.pop("WSOVOD_POOL_MAXABS", None)
        try:
            for route in routes:
                if route == "maxabs":
                    os.environ["WSOVOD_POOL_MAXABS"] = "1"
                if "stages" not in out:
                    *stages, out[route] = _forward_and_front(model, p, b, emb)
                    out["stages"] = tuple(stages)
                else:
                    feats, rpn, daf = out["stages"]
                    props = out[routes[0]][3]
                    level_ids = jnp.concatenate(
                        [rpn.level_ids, jnp.zeros_like(b["sam_valid"], jnp.int32)], 1)
                    fused = JaxInstances(props[2], proposal_boxes=props[0],
                                         objectness_logits=props[1], level_ids=level_ids)
                    out[route] = (*model.apply(p, feats, fused, b["image_sizes"], daf, emb,
                                               method=heads), props)
                os.environ.pop("WSOVOD_POOL_MAXABS", None)
        finally:
            if saved is not None:
                os.environ["WSOVOD_POOL_MAXABS"] = saved
        return out

    pool = rpf.roi_pool_fused_batched

    def one_roi_per_step(*args, src_tbl=None, roi_block=None, **kw):
        if src_tbl is not None:  # [B, N / 8] -> [B, N]
            src_tbl = jnp.repeat(src_tbl, 8, axis=1)
        return pool(*args, src_tbl=src_tbl, roi_block=1, **kw)

    on_tpu, interpret = ROIPooler.__dict__["_on_tpu"], rpf._INTERPRET
    ROIPooler._on_tpu = staticmethod(lambda: True)
    rpf._INTERPRET = True
    rpf.roi_pool_fused_batched = one_roi_per_step
    try:
        return jax.tree_util.tree_map(np.array, jax.jit(routed)(params, batch))
    finally:
        ROIPooler._on_tpu = on_tpu
        rpf._INTERPRET = interpret
        rpf.roi_pool_fused_batched = pool


def check_int8_model(yaml, level_ids=False):
    """The port's int8 model (``tiny_cfg(..., quant="int8")``) against
    ``jax_int8_forward(yaml)`` on both routes: the RPN on the JAX features
    and the proposals (the int8 RPN conv) rtol 1e-4; the whole forward's
    probabilities rtol 1e-4 and atol 1e-4 (torch's and XLA's float32
    backbone sums may move an activation across a rounding tie of the int8
    quantization, one step of 127) and its top-5 detections; the ROI heads
    on the JAX package's features, proposals and data-aware vector, where
    fc1's int8 product is bit for bit, rtol 1e-4 and atol 1e-6 as the float
    slices. Returns the port's model, whose pooler's chunks came as
    ``(payload, maxabs)`` pairs. ``level_ids``: the
    ROI heads' proposals carry the RPN's ``level_ids`` (MRRP), the SAM rows
    on branch 0, as the JAX inference draws no random branch."""
    from wsovod_torch.structures.instances import Instances

    ref = jax_int8_forward(yaml)
    batch = make_batch(0)
    tm = torch_model_from_jax(yaml, quant="int8")
    pairs = []
    hook = tm.roi_heads.pooler.register_forward_hook(
        lambda mod, inp, out: pairs.append(isinstance(out, tuple) and out[1].dim() == 2))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        tdet, tprobs, tboxes, tprops = tm(tb, embeddings=torch.from_numpy(embeddings()),
                                          return_proposals=True)
    hook.remove()
    assert pairs and all(pairs), pairs
    (feats, rpn, daf) = ref["stages"]
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    sizes = torch.from_numpy(batch["image_sizes"])
    with torch.inference_mode():
        t = tm.proposal_generator(tfeats, sizes)
    np.testing.assert_array_equal(t.valid.numpy(), rpn.valid)
    np.testing.assert_allclose(t.objectness_logits.numpy(), rpn.objectness_logits, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t.proposal_boxes.numpy(), rpn.proposal_boxes, rtol=1e-4,
                               atol=1e-3)
    for route in ("default", "maxabs"):
        jdet, jprobs, jboxes, jprops = ref[route]
        np.testing.assert_array_equal(tprops[2].numpy(), jprops[2])
        np.testing.assert_allclose(tprops[0].numpy(), jprops[0], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(tprops[1].numpy(), jprops[1], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tprobs.numpy(), jprobs, rtol=1e-4, atol=1e-4, err_msg=route)
        np.testing.assert_allclose(tboxes.numpy(), jboxes, rtol=1e-4, atol=1e-3)
        for i in range(batch["images"].shape[0]):
            v = jdet.valid[i]
            top = np.argsort(np.where(v, -jdet.scores[i], np.inf), kind="stable")[:5]
            top = top[v[top]]
            assert len(top) == 5
            np.testing.assert_array_equal(tdet.valid[i].numpy()[top], True)
            np.testing.assert_array_equal(tdet.classes[i].numpy()[top], jdet.classes[i][top])
            np.testing.assert_allclose(tdet.scores[i].numpy()[top], jdet.scores[i][top],
                                       rtol=1e-4, atol=1e-4)
        # the ROI heads on the JAX package's features, proposals and vector
        extra = {}
        if level_ids:
            extra["level_ids"] = torch.from_numpy(np.concatenate(
                [rpn.level_ids, np.zeros_like(batch["sam_valid"], np.int32)], 1))
        props = Instances(torch.from_numpy(jprops[2]), proposal_boxes=torch.from_numpy(jprops[0]),
                          objectness_logits=torch.from_numpy(jprops[1]), **extra)
        with torch.inference_mode():
            _, hprobs, hboxes = tm.roi_heads.inference(
                tfeats, props, sizes, data_aware_features=torch.from_numpy(daf),
                embeddings=torch.from_numpy(embeddings()))
        np.testing.assert_allclose(hprobs.numpy(), jprobs, rtol=1e-4, atol=1e-6, err_msg=route)
        np.testing.assert_allclose(hboxes.numpy(), jboxes, rtol=1e-4, atol=1e-3)
    return tm


# ------------------------------------------------ the emission modes' checks
def np_quantize_tiles(v: np.ndarray, c_tile: int):
    """The int8 emission's formula in numpy float32, independent of the
    port's code: per ``c_tile`` channels of ``v [..., P, P, c]``, ``m = max
    |v|``, ``round(v * (127 / m))`` (half to even; 0 where ``m <= 1e-20``)
    as int8; returns ``(q [..., P, P, c], m [..., c / c_tile])``."""
    *lead, p, _, c = v.shape
    t = v.astype(np.float32).reshape(*lead, p, p, c // c_tile, c_tile)
    m = np.abs(t).max(axis=(-4, -3, -1))
    inv = np.where(m > 1e-20, np.float32(127.0) / np.where(m > 0, m, 1), 0).astype(np.float32)
    q = np.round(t * inv[..., None, None, :, None]).astype(np.int8)
    return q.reshape(v.shape), m


def np_quant_scale(gate: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``(gate * m) * (1 / 127)`` in float32."""
    return (gate.astype(np.float32) * m) * np.float32(1.0 / 127.0)


def jax_pool_emissions(feat, rois, gate, specs, c_tile, src=None, scale=0.125, p=3):
    """``roi_pool_fused_batched`` (the TPU kernel) in Pallas interpret mode
    on the whole channel range, for each ``(quant, loop_pool, routed)`` of
    ``specs`` (``routed``: ``src_tbl`` is the per-ROI source copy ``src [B,
    N]``), all under one ``jax.jit`` as the pooler runs it (XLA makes its
    ``/ 127.0`` a multiplication by the float32 reciprocal; one compiled
    program, since a CPU compile costs about half a second of its own), with
    one ROI per grid step (``roi_block=1``: the block size only sets how
    many ROIs a step unrolls, and one traces in a quarter of the time) and
    ``p x p`` bins (default 3: the kernel's trace grows with its bins; the
    tests hold the port at 7 against the jnp reference). Returns a list of
    numpy ``(payload, second)``, the payload in the port's layout ``[(3,)
    B, N, p, p, c]``."""
    import jax
    import jax.numpy as jnp

    from wsovod_tpu.ops.pallas.roi_pool_fused import roi_pool_fused_batched

    def run(f, r, g, s):
        return [roi_pool_fused_batched(f, r, g, 0, p, scale, c_take=f.shape[-1], c_tile=c_tile,
                                       roi_block=1, loop_pool=loop, quant=quant,
                                       src_tbl=s if routed else None, interpret=True)
                for quant, loop, routed in specs]

    outs = jax.jit(run)(jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(gate),
                        None if src is None else jnp.asarray(src, jnp.int32))
    got = []
    for (_, loop, _), out in zip(specs, outs):
        payload, second = (np.asarray(x) for x in out)
        axes = (0, 1, 4, 2, 3, 5) if loop else (0, 3, 1, 2, 4)  # hwnc -> n-major
        got.append((payload.transpose(axes), second))
    return got


def clip_to_image(rois: np.ndarray, img_w: float, img_h: float) -> np.ndarray:
    """Boxes clipped to the image: the TPU kernel's default wide path is
    exact only for those (ROADMAP 3.1)."""
    out = rois.copy()
    out[..., 0::2] = out[..., 0::2].clip(0, img_w)
    out[..., 1::2] = out[..., 1::2].clip(0, img_h)
    return out


# ------------------------------------------- the level-routed pools (2.5)
LEVEL_SCALES = (0.25, 0.125, 0.0625, 0.03125)  # p2-p5
LEVEL_CANONICAL = 28.0  # a small canonical box: the ROIs of a small image fall on every level


def level_pool_inputs(seed=0, b=2, img_h=100, img_w=136, c=8, n=40):
    """An FPN's four levels of an ``img_h x img_w`` image (p2-p5, each
    coarser level padded as ``PatchMerging`` pads an odd side), boxes from a
    size mix over all levels plus overhanging, degenerate, whole-image,
    wholly outside and invalid rows, the ``(objectness+1)*valid`` gate.
    Returns ``(feats, rois, gate, valid)``, numpy, invalid rows zeroed."""
    rng = np.random.RandomState(seed)
    feats, h, w = [], -(-img_h // 4), -(-img_w // 4)
    for _ in LEVEL_SCALES:
        feats.append(rng.randn(b, h, w, c).astype(np.float32))
        h, w = -(-h // 2), -(-w // 2)
    xy = rng.uniform(-10, img_w * 0.7, (b, n, 2))
    wh = np.exp(rng.uniform(np.log(2.0), np.log(img_w * 0.9), (b, n, 2)))
    rois = np.concatenate([xy, xy + wh], -1)
    rois[:, 0] = [img_w - 30, img_h - 20, img_w + 60, img_h + 50]  # overhangs right/bottom
    rois[:, 1] = [-50, -40, 40, 30]  # overhangs left/top
    rois[:, 2] = [50, 40, 20, 10]  # degenerate: x2 < x1, y2 < y1
    rois[:, 3] = [4, 12, 100, 60]  # .5 boundaries at p3
    rois[:, 4] = [0, 0, img_w, img_h]  # the whole image
    rois[:, 5] = [-400, -300, -200, -100]  # wholly outside
    rois[:, 6] = [30, 30, 31, 31]  # one pixel
    valid = rng.rand(b, n) > 0.15
    valid[:, :7] = True
    valid[:, 7] = False
    gate = ((rng.rand(b, n) + 1.0) * valid).astype(np.float32)
    rois = np.where(valid[..., None], rois, 0.0).astype(np.float32)
    return feats, rois, gate, valid


def jax_level_pool(feats, rois, gate, valid, pooler_type, dtypes):
    """The JAX package's multi-level ``ROIPooler`` (the jnp path: every
    level pools every ROI, each ROI keeps its level's) at ``LEVEL_SCALES``
    and ``LEVEL_CANONICAL``, unmasked, on the features cast to each of
    ``dtypes``, times the gate cast to the pooled dtype as the unfused ROI
    heads gate it (``wsovod_tpu/models/roi_heads.py:266-275``); a list of
    float32 numpy ``[(3,) B, N, 7, 7, C]``, one per dtype, from one program
    traced under ``concrete_pooler_scales``."""
    import jax
    import jax.numpy as jnp

    from wsovod_tpu.models.poolers import ROIPooler

    pooler = ROIPooler(7, LEVEL_SCALES, pooler_type=pooler_type,
                       canonical_box_size=LEVEL_CANONICAL)

    def gated(fs, r, v, gt):
        outs = []
        for dtype in dtypes:
            out = pooler([f.astype(dtype) for f in fs], r, v, mask_invalid=False)
            g = gt.astype(out.dtype)
            g = g[None, :, :, None, None, None] if out.ndim == 6 else g[:, :, None, None, None]
            outs.append(out * g)  # in the pooled dtype: a cast here would skip its rounding
        return outs

    with concrete_pooler_scales():
        outs = jax.jit(gated)([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                              jnp.asarray(valid), jnp.asarray(gate))
    return [np.asarray(o.astype(jnp.float32)) for o in outs]


def port_levels(rois: np.ndarray) -> torch.Tensor:
    """The port's level of each ROI at ``LEVEL_SCALES`` and ``LEVEL_CANONICAL``."""
    from wsovod_torch.models.poolers import assign_boxes_to_levels

    lo = int(round(-np.log2(LEVEL_SCALES[0])))
    return assign_boxes_to_levels(torch.from_numpy(rois), lo, lo + len(LEVEL_SCALES) - 1,
                                  LEVEL_CANONICAL)


def jax_pallas_per_level(feats, rois, gate, level, loop, p=3, levels=None):
    """``roi_pool_pallas`` / ``roi_loop_pool_pallas`` (kernel 2.5) in Pallas
    interpret mode, one ROI per grid step and ``p x p`` bins, per image and
    level on all of the image's ROIs, each ROI keeping its level's output,
    times the gate; float32 numpy ``[(3,) B, N, p, p, C]``, zero for the
    ROIs of a level not in ``levels`` (default all: each level costs a
    trace of the kernel, seconds for the loop pool's)."""
    import jax.numpy as jnp

    from wsovod_tpu.ops.pallas.roi_pool_kernel import roi_loop_pool_pallas, roi_pool_pallas

    fn = roi_loop_pool_pallas if loop else roi_pool_pallas
    b, n = gate.shape
    c = feats[0].shape[-1]
    out = np.zeros(((3,) if loop else ()) + (b, n, p, p, c), np.float32)
    for lvl, (f, s) in enumerate(zip(feats, LEVEL_SCALES)):
        if levels is not None and lvl not in levels:
            continue
        for i in range(b):
            sel = level[i] == lvl
            if not sel.any():
                continue
            pooled = np.asarray(fn(jnp.asarray(f[i]), jnp.asarray(rois[i]), p, s, c_tile=c,
                                   roi_block=1, interpret=True))
            pooled = pooled * gate[i][:, None, None, None]
            if loop:
                out[:, i, sel] = pooled[:, sel]
            else:
                out[i, sel] = pooled[sel]
    return out
