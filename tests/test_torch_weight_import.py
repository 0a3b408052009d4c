"""Weight import and package hygiene of the port:

* reference-named random blobs -> ``wsovod_tpu``'s ``import_wsovod_model``
  -> ``state_dict_from_jax`` come back bit-equal, and load into the port's
  model with ``strict=True``, whose ``state_dict`` gives them back again;
* ``wsovod_torch`` imports and builds its models, plain and MRRP, with
  ``jax``, ``flax`` and ``wsovod_tpu`` blocked from import;
* the port's own config tree equals the JAX package's apart from the four
  port defaults, before and after merging the YAMLs; the keys it refuses by
  name.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import MRRP_YAML, REPO, TINY_YAML, embeddings, make_batch, tiny_cfg
from wsovod_tpu.utils.weight_import import import_wsovod_model
from wsovod_torch import check_supported, get_cfg
from wsovod_torch.models import build_model
from wsovod_torch.utils.weight_import import state_dict_from_jax


def _template():
    """Shapes of the JAX parameter tree (no compute: ``eval_shape``)."""
    from wsovod_tpu.config import get_cfg as jax_get_cfg
    from wsovod_tpu.models import build_model as jax_build_model

    model = jax_build_model(tiny_cfg(jax_get_cfg()))
    batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
    return jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, batch,
                                             train=False, embeddings=jnp.asarray(embeddings())))


def test_weight_import_round_trip():
    """Reference-named blobs through the reference importer and back are
    bit-equal and load with ``strict=True``; fc1 is re-laid out once, at
    load."""
    _check_round_trip_through_reference_importer()
    _check_fc1_is_stored_chunk_major_inside()


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
from torch_port_common import MRRP_YAML, TINY_YAML, tiny_cfg, make_batch, embeddings
batch = {{k: torch.from_numpy(v) for k, v in make_batch().items()}}
for yaml in (TINY_YAML, MRRP_YAML):
    model = build_model(tiny_cfg(wsovod_torch.get_cfg(), yaml), device="cpu", seed=0)
    with torch.inference_mode():
        det, probs, boxes = model(batch, embeddings=torch.from_numpy(embeddings()))
    assert bool(det.valid.any())
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "wsovod_tpu") and sys.modules[m] is not None]
assert not bad, bad
assert "WSOVOD_NO_COMPILE_CACHE" not in os.environ
print("OK")
"""


def test_port_config_and_jax_free_import():
    """The port runs with JAX blocked from import, states its own defaults,
    and refuses every unported key by name."""
    _check_port_runs_with_jax_blocked()
    _check_port_defaults()
    for yaml, key, value in ([(TINY_YAML, k, v) for k, v in _UNPORTED]
                             + [(MRRP_YAML, k, v) for k, v in _UNPORTED_MRRP]):
        cfg = tiny_cfg(get_cfg(), yaml)
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)
        with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
            build_model(cfg, device="cpu")


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
                 os.path.join(configs, "WSOVOD_MRRP_WSR_50_DC5_1x.yaml")):
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
        if yaml is not None and "WSR_50" in yaml:
            cfg = get_cfg()
            cfg.merge_from_file(yaml)
            cfg.TEST.AUG.ENABLED = False
            check_supported(cfg)


_UNPORTED = [
    ("TEST.AUG.ENABLED", True),
    ("TPU.DAN_FC1_QUANT", "int8"),
    ("TPU.RPN_CONV_QUANT", "int8"),
    ("TPU.BACKBONE_CONV_QUANT", "int8"),
    ("MODEL.MRRP.MRRP_ON", True),
    ("MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlignV2"),
    ("MODEL.META_ARCHITECTURE", "GeneralizedRCNN_WSOVOD_MixedDatasets"),
    ("MODEL.BACKBONE.NAME", "build_vgg_backbone"),
    ("MODEL.BACKBONE.NAME", "build_mrrp_vgg_backbone"),
]
# refused on the MRRP config (ROILoopPool is ported, with or without MRRP)
_UNPORTED_MRRP = [
    ("MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlignV2"),
    ("MODEL.MRRP.MRRP_STAGE", "res4"),
    ("MODEL.MRRP.TEST_BRANCH_IDX", 3),
    ("MODEL.MRRP.BRANCH_DILATIONS", [1, 2]),
]
