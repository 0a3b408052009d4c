"""Weight import and package hygiene of the port:

* reference-named random blobs -> ``wsovod_tpu``'s ``import_wsovod_model``
  -> ``state_dict_from_jax`` come back bit-equal, and load into the port's
  model with ``strict=True``, whose ``state_dict`` gives them back again;
* ``wsovod_torch`` imports and builds its models, plain and MRRP, and its
  trainer takes an iteration, and the 2.9 microbenchmarks' entry points
  (``wsovod_torch.scripts``) exit non-zero without a card, with ``jax``,
  ``flax`` and ``wsovod_tpu`` blocked from import and nothing of the JAX
  package's ``scripts/`` imported;
* the port's own config tree equals the JAX package's apart from the four
  port defaults, before and after merging the YAMLs; the keys it refuses by
  name; feature names the backbone does not give raise a ``ValueError``
  naming the key and the backbone's features; the ROIAlign poolers it
  admits, and the windowed align it refuses for training; the int8 fc1 and
  RPN conv it admits with every pooler, for inference and training (which
  ignores them), and their models load the same weights; the Swin FPN
  detector with ROIPool and ROILoopPool it admits for inference, also with
  the int8 keys (the RPN conv int8 on every level, fc1 in floating point as
  the JAX package's unfused multi-level path runs it), and refuses by name
  on several levels the ROIAlign, MRRP and pooled levels out of order or
  with a gap, and its training; an ``RPN.IN_FEATURES`` other than the
  backbone's first outputs is refused by name (ROADMAP 3.14);
* the Swin FPN's tree (Dense ``[in, out]`` to ``Linear [out, in]``, conv
  HWIO to OIHW, the relative position bias tables, the LayerNorms, the
  bias-free ``reduction``, ``fpn_lateral_*``/``fpn_output_*``) loads into
  the port's model with ``strict=True`` and comes back bit-equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_common import (
    MRRP_VGG_YAML, MRRP_YAML, REPO, SWIN_YAML, TINY_YAML, VGG_YAML, jax_reference, random_params,
    tiny_cfg,
)
from wsovod_tpu.utils.weight_import import import_wsovod_model
from wsovod_torch import check_supported, get_cfg
from wsovod_torch.config import check_train_supported
from wsovod_torch.models import build_model
from wsovod_torch.utils.weight_import import backbone_state_dict_from_jax, state_dict_from_jax


def _template():
    """The JAX parameter tree of the tiny config, object miner included
    (its training-mode ``init``)."""
    return jax_reference()[1]


def test_weight_import_round_trip():
    """Reference-named blobs through the reference importer and back are
    bit-equal and load with ``strict=True``; fc1 is re-laid out once, at
    load."""
    _check_round_trip_through_reference_importer()
    _check_fc1_is_stored_chunk_major_inside()
    _check_swin_fpn_tree()


def _check_swin_fpn_tree():
    """The tiny Swin FPN's JAX tree (the backbone of ``tiny_cfg(cfg,
    SWIN_YAML)``; the heads' tree is the R18 config's, above) ->
    ``backbone_state_dict_from_jax`` -> the port's backbone
    (``strict=True``) -> its ``state_dict``: bit-equal, each leaf in
    torch's layout."""
    import jax
    import jax.numpy as jnp

    from wsovod_tpu.config import get_cfg as jax_get_cfg
    from wsovod_tpu.models.backbones import build_backbone as jax_build_backbone

    jm = jax_build_backbone(tiny_cfg(jax_get_cfg(), SWIN_YAML))
    tree = random_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 32, 32, 3)))))["params"]
    sd = backbone_state_dict_from_jax(tree)
    model = build_model(tiny_cfg(get_cfg(), SWIN_YAML), device="cpu", seed=None)
    model.backbone.load_state_dict(sd, strict=True)
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, sd[k]), k
    bu, bb = tree["bottom_up"], "bottom_up."
    pairs = {
        bb + "patch_embed.proj.weight": bu["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
        bb + "patch_embed.norm.weight": bu["patch_norm"]["scale"],
        bb + "layers.0.blocks.1.attn.qkv.weight": bu["stage2_block1"]["attn"]["qkv"]["kernel"].T,
        bb + "layers.0.blocks.1.attn.relative_position_bias_table":
            bu["stage2_block1"]["attn"]["relative_position_bias_table"],
        bb + "layers.1.blocks.0.mlp.fc2.bias": bu["stage3_block0"]["mlp_fc2"]["bias"],
        bb + "layers.2.downsample.reduction.weight": bu["merge4"]["reduction"]["kernel"].T,
        bb + "norm3.bias": bu["stage5_norm"]["bias"],
        "fpn_lateral5.weight": tree["fpn_lateral_stage5"]["kernel"].transpose(3, 2, 0, 1),
        "fpn_output2.bias": tree["fpn_output_stage2"]["bias"],
    }
    for k, v in pairs.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert bb + "layers.2.downsample.reduction.bias" not in sd


def _check_round_trip_through_reference_importer():
    model = build_model(tiny_cfg(get_cfg()), device="cpu", seed=None)
    rng = np.random.RandomState(0)
    blobs = {k: rng.randn(*v.shape).astype(np.float32) for k, v in model.state_dict().items()}
    c = model.roi_heads.box_head.fc1.c
    params = import_wsovod_model(blobs, _template(), depth=18, pooled_shape=(c, 7, 7))
    back = state_dict_from_jax(params)
    assert sorted(back) == sorted(blobs)
    for k, v in blobs.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)

    model.load_state_dict(back, strict=True)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), blobs[k], err_msg=k)
    # the ROIAlignV2 pooler has no parameters: the same tree loads into its model
    align = build_model(tiny_cfg(get_cfg(), pooler="ROIAlignV2"), device="cpu", seed=None)
    align.load_state_dict(back, strict=True)
    for k, v in align.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), blobs[k], err_msg=k)


def _check_fc1_is_stored_chunk_major_inside():
    """Loading re-lays fc1 out once; the chunk view equals the reference
    weight's (h, w, c) slice of that chunk."""
    from wsovod_torch.models.box_head import ChunkedLinear

    lin = ChunkedLinear(in_channels=8, pooled=3, out_features=5, c_take=4)
    ref = torch.randn(5, 8 * 3 * 3, generator=torch.Generator().manual_seed(0))
    lin.load_state_dict({"weight": ref, "bias": torch.zeros(5)})
    for k in range(2):
        want = ref.view(5, 8, 3, 3)[:, 4 * k:4 * k + 4].permute(0, 2, 3, 1).reshape(5, -1)
        assert torch.equal(lin.chunk_weight(k), want)
    assert torch.equal(lin.state_dict()["weight"], ref)


_BLOCKED = """
import os
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["wsovod_tpu"] = None
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import torch
import wsovod_torch
from wsovod_torch.models import build_model
from torch_port_common import (MRRP_YAML, SWIN_YAML, TINY_YAML, batch_for, tiny_cfg, make_batch,
                               embeddings)
for yaml, quant in ((TINY_YAML, "none"), (TINY_YAML, "int8"), (MRRP_YAML, "none"),
                    (MRRP_YAML, "int8"), (SWIN_YAML, "none"), (SWIN_YAML, "int8")):
    batch = {{k: torch.from_numpy(v) for k, v in batch_for(yaml, 0).items()}}
    model = build_model(tiny_cfg(wsovod_torch.get_cfg(), yaml, quant=quant), device="cpu", seed=0)
    with torch.inference_mode():
        det, probs, boxes = model(batch, embeddings=torch.from_numpy(embeddings()))
    assert bool(det.valid.any())
# the training modules: one iteration of the trainer
import tempfile
from wsovod_torch.engine.trainer import WSOVODTrainer
cfg = tiny_cfg(wsovod_torch.get_cfg())
cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN, cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64, 16
cfg.SOLVER.MAX_ITER, cfg.MODEL.WEIGHTS = 1, ""
with tempfile.TemporaryDirectory() as out:
    cfg.OUTPUT_DIR = out
    trainer = WSOVODTrainer(cfg, iter([make_batch(gt=True)]),
                            embeddings=torch.from_numpy(embeddings()), device="cpu")
    trainer.train()
    assert trainer.step.step == 1
# the 2.9 microbenchmarks' entry points: without a card they exit non-zero
from wsovod_torch.scripts import bench_i8walk, bench_vpu_pack
if not torch.cuda.is_available():
    assert bench_vpu_pack.main() != 0 and bench_i8walk.main() != 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "wsovod_tpu", "scripts")
       and sys.modules[m] is not None]
assert not bad, bad
assert "WSOVOD_NO_COMPILE_CACHE" not in os.environ
print("OK")
"""


def test_port_config_and_jax_free_import():
    """The port runs with JAX blocked from import, states its own defaults,
    refuses every unported key by name, and names the feature key that asks
    for a feature the backbone lacks."""
    _check_port_runs_with_jax_blocked()
    _check_port_defaults()
    for yaml, key, value in ([(TINY_YAML, k, v) for k, v in _UNPORTED]
                             + [(MRRP_YAML, k, v) for k, v in _UNPORTED_MRRP]
                             + [(MRRP_VGG_YAML, k, v) for k, v in _UNPORTED_MRRP_VGG]):
        cfg = tiny_cfg(get_cfg(), yaml)
        _set(cfg, key, value)
        with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
            build_model(cfg, device="cpu")
    for key, value, why in _UNPORTED_SWIN:
        cfg = tiny_cfg(get_cfg(), SWIN_YAML)
        _set(cfg, key, value)
        with pytest.raises(NotImplementedError, match=why):
            build_model(cfg, device="cpu")
    # the VGG YAMLs as shipped inherit RPN.IN_FEATURES ["res5"]: named, not
    # a KeyError, and not rewritten; likewise a pooled feature the ResNet
    # does not give
    for yaml, key in ((VGG_YAML, "MODEL.RPN.IN_FEATURES"), (MRRP_VGG_YAML, "MODEL.RPN.IN_FEATURES"),
                      (TINY_YAML, "MODEL.ROI_HEADS.IN_FEATURES")):
        cfg = get_cfg()
        cfg.merge_from_file(yaml)
        cfg.TEST.AUG.ENABLED = False
        if yaml == TINY_YAML:
            cfg.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
        features = "'plain5'" if "V_16" in yaml else "'res5'"
        with pytest.raises(ValueError, match=key.replace(".", r"\.") + ".*features are \\[" + features):
            check_supported(cfg)
        assert cfg.MODEL.RPN.IN_FEATURES == ["res5"]
    _check_admitted_poolers()


def _check_admitted_poolers():
    """``ROIAlignV2`` and ``ROIAlign`` on the plain, MRRP and MRRP VGG16
    configs: built, and admitted for training with every
    ``TPU.ROI_ALIGN_KERNEL``, except the windowed one (``pallas_approx``)
    while the pooled stage trains, which ``check_train_supported`` refuses
    by name (its TPU kernel has no VJP). Both int8 keys with every pooler:
    built (the ROILoopPool's chunk is 256 channels, the others' 512), the
    reference weights load into the model with ``strict=True`` as into the
    floating-point one, and admitted for training."""
    back = state_dict_from_jax(_template())
    # the Swin FPN: ROIPool and ROILoopPool on p2-p5 for inference, its
    # training refused by name with the reason; with both int8 keys, the RPN
    # conv int8 on its five levels and fc1 in floating point (the JAX
    # package's unfused path); the Swin alone on one level admitted, its
    # training refused by name
    for pooler in ("ROIPool", "ROILoopPool"):
        cfg = tiny_cfg(get_cfg(), SWIN_YAML, pooler=pooler, quant="int8")
        model = build_model(cfg, device="cpu", seed=None)
        assert model.proposal_generator.rpn_head.conv.quant == "int8"
        assert model.roi_heads.box_head.fc1.quant == "none" and model.roi_heads.c_take == 32
        cfg = tiny_cfg(get_cfg(), SWIN_YAML, pooler=pooler)
        cfg.MODEL.ROI_HEADS.IN_FEATURES = ["p3", "p4", "p5"]  # consecutive from p3
        check_supported(cfg)
        cfg = tiny_cfg(get_cfg(), SWIN_YAML, pooler=pooler)
        model = build_model(cfg, device="cpu", seed=None)
        assert model.roi_heads.in_features == ("p2", "p3", "p4", "p5")
        assert model.proposal_generator.in_features == ("p2", "p3", "p4", "p5", "p6")
        with pytest.raises(NotImplementedError, match=r"ROI_HEADS\.IN_FEATURES.*no VJP"):
            check_train_supported(cfg)
        cfg.MODEL.BACKBONE.NAME = "build_swin_backbone"
        cfg.MODEL.RPN.IN_FEATURES = cfg.MODEL.ROI_HEADS.IN_FEATURES = ["stage5"]
        # the RPN's anchor strides are the backbone's first outputs'
        # (ROADMAP 3.14): stage5 with stage2-5 out is refused, stage5 alone
        # admitted
        with pytest.raises(NotImplementedError, match=r"RPN\.IN_FEATURES.*first outputs"):
            check_supported(cfg)
        cfg.MODEL.SWIN.OUT_FEATURES = ["stage5"]
        check_supported(cfg)
        with pytest.raises(NotImplementedError, match=r"BACKBONE\.NAME.*Swin"):
            check_train_supported(cfg)
    for yaml in (TINY_YAML, MRRP_YAML, MRRP_VGG_YAML):
        for pooler in ("ROIPool", "ROILoopPool", "ROIAlignV2"):
            cfg = tiny_cfg(get_cfg(), yaml, pooler=pooler, quant="int8")
            model = build_model(cfg, device="cpu", seed=None)
            assert model.roi_heads.c_take == (256 if pooler == "ROILoopPool" else 512)
            assert model.proposal_generator.rpn_head.conv.quant == "int8"
            if yaml == TINY_YAML:
                model.load_state_dict(back, strict=True)
            check_train_supported(cfg)
    for yaml in (TINY_YAML, MRRP_YAML, MRRP_VGG_YAML):
        for pooler in ("ROIAlignV2", "ROIAlign"):
            cfg = tiny_cfg(get_cfg(), yaml, pooler=pooler)
            model = build_model(cfg, device="cpu")
            assert model.roi_heads.pooler.aligned == (pooler == "ROIAlignV2")
            for kernel in ("fused", "pallas", "gather", "pallas_approx"):
                cfg.TPU.ROI_ALIGN_KERNEL = kernel
                for freeze_at in (5, 4):
                    cfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
                    if kernel == "pallas_approx" and pooler == "ROIAlignV2" and freeze_at == 4:
                        with pytest.raises(NotImplementedError, match=r"TPU\.ROI_ALIGN_KERNEL"):
                            check_train_supported(cfg)
                    else:
                        check_train_supported(cfg)


def _set(cfg, key, value):
    node = cfg
    *parents, leaf = key.split(".")
    for p in parents:
        node = getattr(node, p)
    setattr(node, leaf, value)


def _check_port_runs_with_jax_blocked():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "WSOVOD_NO_COMPILE_CACHE", "PYTHONPATH")}
    code = _BLOCKED.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]


# the port's defaults where its tree differs from the JAX package's
_PORT_DEFAULTS = {"MODEL.DEVICE": "cuda", "TPU.DAN_FC1_QUANT": "none",
                  "TPU.RPN_CONV_QUANT": "none", "TPU.COMPUTE_DTYPE": "bfloat16"}


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _check_port_defaults():
    """The port's tree is the JAX package's, key by key, apart from the
    port defaults, as defaults and after merging the plain and the MRRP
    YAMLs (R18 and R50); the two slices' configs pass once TTA is off."""
    from wsovod_tpu.config import get_cfg as jax_get_cfg

    configs = os.path.join(REPO, "configs", "COCO-Detection")
    for yaml in (None, TINY_YAML, MRRP_YAML, os.path.join(configs, "WSOVOD_WSR_50_DC5_1x.yaml"),
                 os.path.join(configs, "WSOVOD_MRRP_WSR_50_DC5_1x.yaml"), VGG_YAML,
                 MRRP_VGG_YAML):
        port, ref = get_cfg(), jax_get_cfg()
        if yaml is not None:
            port.merge_from_file(yaml)
            ref.merge_from_file(yaml)
        port, ref = _flat(port), _flat(ref)
        assert sorted(port) == sorted(ref), yaml
        differ = {k for k in port if port[k] != ref[k] or type(port[k]) is not type(ref[k])}
        assert differ <= set(_PORT_DEFAULTS), (yaml, differ)
        for k, v in _PORT_DEFAULTS.items():
            assert port[k] == v, (yaml, k)
        if yaml is not None and ("WSR_50" in yaml or "V_16" in yaml):
            cfg = get_cfg()
            cfg.merge_from_file(yaml)
            cfg.TEST.AUG.ENABLED = False
            if "V_16" in yaml:
                cfg.MODEL.RPN.IN_FEATURES = ["plain5"]
            check_supported(cfg)


_UNPORTED = [
    ("TEST.AUG.ENABLED", True),
    ("TPU.DAN_FC1_QUANT", "fp8"),
    ("TPU.RPN_CONV_QUANT", "int4"),
    ("TPU.BACKBONE_CONV_QUANT", "int8"),
    ("MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlignRotated"),
    ("MODEL.META_ARCHITECTURE", "GeneralizedRCNN_WSOVOD_MixedDatasets"),
    ("MODEL.BACKBONE.NAME", "build_deform_resnet_backbone"),
]
# refused on the Swin FPN config: pooled on several levels, the ROIAlign
# (a routed multi-level align is later work), MRRP, levels out of order or
# with a gap (the pooler indexes the maps by level - min_level)
_UNPORTED_SWIN = [
    ("MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlignV2", "routed multi-level align"),
    ("MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlign", "routed multi-level align"),
    ("MODEL.MRRP.MRRP_ON", True, "MRRP on several levels"),
    ("MODEL.ROI_HEADS.IN_FEATURES", ["p5", "p4", "p3", "p2"], r"ROI_HEADS\.IN_FEATURES.*consecutive"),
    ("MODEL.ROI_HEADS.IN_FEATURES", ["p2", "p4"], r"ROI_HEADS\.IN_FEATURES.*consecutive"),
    # anchor strides per RPN.IN_FEATURES: a departure from the JAX package,
    # whose RPN takes the backbone's first strides (ROADMAP 3.14)
    ("MODEL.RPN.IN_FEATURES", ["p3", "p4", "p5", "p6"], r"RPN\.IN_FEATURES.*first outputs"),
    # the FPN gives its levels in FPN.IN_FEATURES order: p3 first here, so
    # p2-p6 would anchor p2 at p3's stride
    ("MODEL.FPN.IN_FEATURES", ["stage3", "stage2", "stage4", "stage5"],
     r"RPN\.IN_FEATURES.*first outputs \['p3', 'p2'"),
]
# refused on the MRRP config (ROIPool, ROILoopPool, ROIAlignV2 and ROIAlign
# are ported, with or without MRRP, on one level)
_UNPORTED_MRRP = [
    ("MODEL.ROI_HEADS.IN_FEATURES", ["res4", "res5"]),
    ("MODEL.MRRP.MRRP_STAGE", "res4"),
    ("MODEL.MRRP.MRRP_STAGE", "plain5"),
    ("MODEL.MRRP.TEST_BRANCH_IDX", 3),
    ("MODEL.MRRP.BRANCH_DILATIONS", [1, 2]),
]
# refused on the MRRP VGG16 config
_UNPORTED_MRRP_VGG = [
    ("MODEL.VGG.DEPTH", 19),
    ("MODEL.MRRP.MRRP_STAGE", "plain4"),
    ("MODEL.MRRP.MRRP_STAGE", "res5"),
    ("MODEL.ROI_HEADS.IN_FEATURES", ["plain4", "plain5"]),
]
