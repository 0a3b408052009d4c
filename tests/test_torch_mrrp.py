"""MRRP inference of the port against ``wsovod_tpu`` on the CPU.

* The plain ROILoopPool (the CUDA kernel's CPU stand-in) against
  ``wsovod_tpu.ops.roi_pool.roi_loop_pool`` times the gate, per ROI on the
  feature copy its branch names: exact, float32 and bfloat16. Its backward
  (``roi_loop_pool_gated_bwd_plain``) against the JAX package's own
  ``_pool_branched_bwd`` (MRRP routing) and ``_pool_ad_bwd`` with
  ``loop_pool=True`` (one copy per image) on tie-heavy features, float32,
  rtol 1e-5 (float32 summation order); and the halved cotangent of a bin
  whose max ties 0.
* The forward on the tiny MRRP R18 config (``configs/COCO-Detection/
  WSOVOD_MRRP_WSR_18_DC5_1x.yaml`` cut as ``tiny_cfg``) against
  ``model.apply(..., train=False)``, with all branches at test and with one.
  On the CPU the JAX pooler takes its unfused per-branch path, so no Pallas
  interpret run is involved. Tolerances as the plain slice's: rtol 1e-4, box
  atol 1e-3; validity, classes and ``level_ids`` exactly.
* The weight round trip on the MRRP training tree, and ContextLocNet's
  object miner loaded from it against the JAX package's (rtol 1e-5).

Three test items on purpose: many small items queued behind the JAX
package's heavy tests have crashed XLA:CPU (ROADMAP.md, host facts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_common import (
    MRRP_YAML, embeddings, jax_reference, jax_stages, make_batch, tiny_cfg, torch_model_from_jax,
)
from wsovod_tpu.ops.pallas.roi_pool_fused import _pool_ad_bwd, _pool_branched_bwd
from wsovod_tpu.ops.roi_pool import roi_loop_pool
from wsovod_tpu.models.mil_heads import ObjectMiningOutputLayers as JaxObjectMiner
from wsovod_tpu.utils.weight_import import import_wsovod_model
from wsovod_torch import get_cfg
from wsovod_torch.models import build_model
from wsovod_torch.models.mil_heads import ObjectMiningOutputLayers
from wsovod_torch.ops.roi_pool import roi_loop_pool_gated, roi_loop_pool_gated_bwd_plain
from wsovod_torch.structures.instances import Instances
from wsovod_torch.utils.weight_import import state_dict_from_jax

RTOL, BOX_ATOL = 1e-4, 1e-3


def _loop_inputs(seed=0, b=2, n_br=3, h=9, w=13, c=12, n=40, scale=0.125):
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


def _jax_loop_gated(feat, rois, gate, src, c_base, c_take, scale, dtype):
    """``roi_loop_pool(feat[src[b, n]], rois[b]) * gate`` per ROI, the
    reference's unfused MRRP pooler path: every copy pools every ROI of its
    image, each ROI keeps its copy's rows. ``[3, B, N, 7, 7, c_take]``."""
    b, n = src.shape
    f = jnp.asarray(feat[..., c_base:c_base + c_take]).astype(dtype)
    out = np.zeros((3, b, n, 7, 7, c_take), np.float32)
    for i in range(b):
        for s in np.unique(src[i]):
            pooled = roi_loop_pool(f[s], jnp.asarray(rois[i]), 7, scale, 1.8)
            pooled = pooled * jnp.asarray(gate[i]).astype(dtype)[None, :, None, None, None]
            sel = src[i] == s
            out[:, i, sel] = np.asarray(pooled.astype(jnp.float32))[:, sel]
    return out


def test_loop_pool_plain_matches_jax():
    """Exact in float32 and bfloat16, on routed branches, edge boxes and a
    channel chunk that starts at 4; ``rows=1`` and ``rows=2`` are the first rows of
    ``rows=3``."""
    scale, c_base, c_take = 0.125, 4, 8
    feat, rois, gate, src = _loop_inputs()
    rois_t, gate_t, src_t = torch.from_numpy(rois), torch.from_numpy(gate), torch.from_numpy(src)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ft = torch.from_numpy(feat).to(dtype)
        want = _jax_loop_gated(feat, rois, gate, src, c_base, c_take, scale, jdtype)
        got = roi_loop_pool_gated(ft, rois_t, gate_t, src_t, c_base, c_take, 3, 7, scale, 1.8)
        assert got.dtype == dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=str(dtype))
        for rows in (1, 2):
            part = roi_loop_pool_gated(ft, rois_t, gate_t, src_t, c_base, c_take, rows, 7, scale, 1.8)
            assert torch.equal(part, got[:rows])
    # the edge rows pool something and the invalid row nothing
    assert (np.abs(want[:, :, :9]).reshape(3, 2, 9, -1).max(-1) > 0).any()
    assert not want[:, :, 9].any()
    _check_loop_backward()


def _check_loop_backward():
    """The plain backward against ``_pool_branched_bwd`` and
    ``_pool_ad_bwd(loop_pool=True)``, each called with ``out`` from the jnp
    ``roi_loop_pool``: values on a 0.5 grid (ties, exact zeros, negatives),
    one copy post-ReLU (bins whose max is 0), the edge boxes of
    ``_loop_inputs`` (overhanging, degenerate, empty holes, wholly outside)
    and gate-0 rows; both cotangents. Then the tie at 0: a 2x2 map of zeros
    pooled into one bin sends each pixel ``g * gate / 2 / 2 / 2`` of the ROI
    row (``jnp.maximum(M, 0)`` halves it, as ``torch.maximum``; a
    ``clamp_min`` would not)."""
    scale, c_base, c_take, b = 0.125, 4, 8, 2
    feat, rois, gate, src = _loop_inputs(1)
    feat = np.round(feat * 2) / 2
    feat[1::b] = np.maximum(feat[1::b], 0)  # branch 0 of image 1, branch 1 of image 0, ...
    feat = feat.astype(np.float32)
    gate[:, 10] = 0.0  # a valid box with gate 0
    g = np.random.RandomState(2).randn(3, b, rois.shape[1], 7, 7, c_take).astype(np.float32)
    hwnc = (0, 1, 3, 4, 2, 5)  # the TPU kernel's [3, B, P, P, N, c] layout
    args = (c_base, c_take, 7, scale, True, 1.8, None, False, None)
    image = np.arange(b, dtype=np.int32)[:, None] + np.zeros_like(src)
    for name, f, s in (("branched", feat, src), ("ad", feat[:b], image)):
        out = _jax_loop_gated(f, rois, gate, s, c_base, c_take, scale, jnp.float32)
        res = (jnp.asarray(f), jnp.asarray(rois), jnp.asarray(gate))
        if name == "branched":
            bwd = jax.jit(lambda res, g: _pool_branched_bwd(*args, res, g))
            res += (jnp.asarray((s // b).astype(np.float32)),)
        else:
            bwd = jax.jit(lambda res, g: _pool_ad_bwd(*args, res, g))
        want_feat, _, want_gate = bwd(res + (jnp.asarray(out.transpose(hwnc)),),
                                      jnp.asarray(g.transpose(hwnc)))[:3]
        got_feat, got_gate = roi_loop_pool_gated_bwd_plain(
            torch.from_numpy(f), torch.from_numpy(rois), torch.from_numpy(gate),
            torch.from_numpy(s), torch.from_numpy(out), torch.from_numpy(g), c_base, c_take, 7,
            scale, 1.8)
        np.testing.assert_allclose(got_feat.numpy(), want_feat, rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got_gate.numpy(), want_gate, rtol=1e-5, atol=1e-5, err_msg=name)
        assert np.abs(want_feat).max() > 0 and (got_gate.numpy()[:, 10] == 0).all()
        assert not got_feat[..., :c_base].any() and not got_feat[..., c_base + c_take:].any()
    # bins whose max ties 0 were in play, so the halving above was exercised
    assert ((out == 0) & (np.abs(g) > 0)).any()

    zeros = torch.zeros(1, 2, 2, 2)
    box, one = torch.tensor([[[0.0, 0.0, 1.0, 1.0]]]), torch.ones(1, 1)
    g1 = torch.zeros(3, 1, 1, 1, 1, 2)
    g1[0] = 0.8
    src = torch.zeros(1, 1, dtype=torch.int32)
    got, _ = roi_loop_pool_gated_bwd_plain(zeros, box, 1.5 * one, src, None, g1, 0, 2, 1, 1.0, 1.8,
                                           need_gate=False)
    assert torch.equal(got, torch.full_like(zeros, 0.8 * 1.5 / 2 / 2 / 2))


def _port_forward(model, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        feats = model.backbone(model._normalize(tb["images"]))
        rpn = model.proposal_generator(feats, tb["image_sizes"])
        out = model(tb, embeddings=torch.from_numpy(embeddings()), return_proposals=True)
    return feats, rpn, out


def test_mrrp_inference_matches_jax():
    """All branches at test (``TEST_BRANCH_IDX -1``) and one (``1``): the
    backbone's branch concat, the RPN's group proposals with their
    ``level_ids``, the ROI heads on the JAX proposals, and the whole forward
    with its top-5 detections. Then the data-aware vector of a single-branch
    batch of three images."""
    _check_single_branch_batch_of_three()
    batch = make_batch(0)
    for idx, n_copies in ((-1, 3), (1, 1)):
        feats, rpn, daf, (det, probs, boxes, props) = jax_stages(0, MRRP_YAML, idx)
        tm = torch_model_from_jax(MRRP_YAML, idx)
        tfeats, trpn, (tdet, tprobs, tboxes, tprops) = _port_forward(tm, batch)

        assert tfeats["res5"].shape[0] == 2 * n_copies == feats["res5"].shape[0]
        np.testing.assert_allclose(tfeats["res5"].numpy(), feats["res5"], rtol=RTOL, atol=1e-4)
        np.testing.assert_array_equal(trpn.valid.numpy(), rpn.valid)
        np.testing.assert_array_equal(trpn.level_ids.numpy(), rpn.level_ids)
        np.testing.assert_allclose(trpn.proposal_boxes.numpy(), rpn.proposal_boxes,
                                   rtol=RTOL, atol=BOX_ATOL)
        np.testing.assert_allclose(trpn.objectness_logits.numpy(), rpn.objectness_logits,
                                   rtol=RTOL, atol=1e-5)
        branches = np.unique(rpn.level_ids[rpn.valid] // 1000)
        assert len(branches) == n_copies, branches

        # the ROI heads on the JAX proposals (SAM rows on branch 0, as the
        # JAX inference draws no random branch) and data-aware vector
        level_ids = np.concatenate([rpn.level_ids, np.zeros_like(batch["sam_valid"], np.int32)], 1)
        jprops = Instances(torch.from_numpy(props[2]), proposal_boxes=torch.from_numpy(props[0]),
                           objectness_logits=torch.from_numpy(props[1]),
                           level_ids=torch.from_numpy(level_ids))
        with torch.inference_mode():
            hdet, hprobs, hboxes = tm.roi_heads.inference(
                {k: torch.from_numpy(v) for k, v in feats.items()}, jprops,
                torch.from_numpy(batch["image_sizes"]), data_aware_features=torch.from_numpy(daf),
                embeddings=torch.from_numpy(embeddings()))
        np.testing.assert_allclose(hprobs.numpy(), probs, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(hboxes.numpy(), boxes, rtol=RTOL, atol=BOX_ATOL)

        np.testing.assert_array_equal(tprops[2].numpy(), props[2])
        np.testing.assert_allclose(tprops[0].numpy(), props[0], rtol=RTOL, atol=BOX_ATOL)
        np.testing.assert_allclose(tprops[1].numpy(), props[1], rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(tprobs.numpy(), probs, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(tboxes.numpy(), boxes, rtol=RTOL, atol=BOX_ATOL)
        for i in range(2):
            v = det.valid[i]
            top = np.argsort(np.where(v, -det.scores[i], np.inf), kind="stable")[:5]
            top = top[v[top]]
            assert len(top) == 5
            np.testing.assert_array_equal(tdet.valid[i].numpy()[top], True)
            np.testing.assert_array_equal(tdet.classes[i].numpy()[top], det.classes[i][top])
            np.testing.assert_allclose(tdet.scores[i].numpy()[top], det.scores[i][top], rtol=RTOL)
            np.testing.assert_allclose(tdet.boxes[i].numpy()[top], det.boxes[i][top],
                                       rtol=RTOL, atol=BOX_ATOL)


def _check_single_branch_batch_of_three():
    """``TEST_BRANCH_IDX 1`` at B=3: the feature's batch divides by
    ``NUM_BRANCH``, so the JAX package takes it for a branch concat and
    averages the three images into one data-aware vector
    (``class_heads.py:106-116``, ROADMAP 3.3); the port does the same."""
    jm, params = jax_reference(MRRP_YAML, 1)
    tm = torch_model_from_jax(MRRP_YAML, 1)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(3, b=3).items()}
    batch["image_sizes"][1] = torch.tensor([48, 40])
    with torch.inference_mode():
        feat = tm.backbone(tm._normalize(batch["images"]))["res5"]
        got = tm._data_aware_features(feat, batch)
    stride = batch["images"].shape[1] // feat.shape[1]
    sizes = batch["image_sizes"].numpy() // stride
    valid = ((np.arange(feat.shape[1])[None, :, None] < sizes[:, 0, None, None])
             & (np.arange(feat.shape[2])[None, None, :] < sizes[:, 1, None, None]))
    want = jm.apply(params, jnp.asarray(feat.numpy()), jnp.asarray(valid),
                    method=lambda m, f, v: m.data_aware_head(f, pixel_valid=v))
    assert feat.shape[0] == 3 and got.shape == want.shape == (1, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


def test_mrrp_weight_round_trip():
    """Reference-named blobs of the MRRP model through the reference
    importer and back are bit-equal and load with ``strict=True``: the
    branches share weights, so the names are the plain model's. The JAX
    training tree (with the object miner) maps onto the port's names, and
    its ContextLocNet miner, ``cls(roi)`` and ``det(frame) - det(ctx)``,
    scores as the JAX package's, also with one class (the zero column). A
    random SAM branch comes from an explicit generator only."""
    model = build_model(tiny_cfg(get_cfg(), MRRP_YAML), device="cpu", seed=None)
    plain = build_model(tiny_cfg(get_cfg()), device="cpu", seed=None)
    assert sorted(model.state_dict()) == sorted(plain.state_dict())
    rng = np.random.RandomState(0)
    blobs = {k: rng.randn(*v.shape).astype(np.float32) for k, v in model.state_dict().items()}
    _, template = jax_reference(MRRP_YAML, -1)  # the JAX model's parameter tree
    c = model.roi_heads.box_head.fc1.c
    back = state_dict_from_jax(import_wsovod_model(blobs, template, depth=18,
                                                   pooled_shape=(c, 7, 7)))
    assert sorted(back) == sorted(blobs)
    for k, v in blobs.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    model.load_state_dict(back, strict=True)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), blobs[k], err_msg=k)

    # the training tree's miner through state_dict_from_jax
    model.load_state_dict(state_dict_from_jax(template), strict=True)
    miner = model.roi_heads.object_miner
    assert miner.context
    jparams = {"params": template["params"]["roi_heads"]["object_miner"]}
    x = rng.randn(3, 2, 7, 64).astype(np.float32)
    valid = rng.rand(2, 7) > 0.3
    for c in (5, 1):
        jm = JaxObjectMiner(num_classes=c, context=True)
        jp = jax.tree_util.tree_map(lambda a: a[..., :c], jparams)
        want = jm.apply(jp, jnp.asarray(x), jnp.asarray(valid))
        tm = ObjectMiningOutputLayers(64, c, context=True)
        tm.load_state_dict({k: v[:c] for k, v in miner.state_dict().items()})
        with torch.inference_mode():
            got = tm(torch.from_numpy(x), torch.from_numpy(valid))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7, err_msg=f"{c} classes")

    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with torch.inference_mode():
        feats = model.backbone(model._normalize(batch["images"]))
        props = [model._proposals(feats, batch, g) for g in (None, torch.Generator().manual_seed(3))]
    sam = slice(-batch["sam_valid"].shape[1], None)
    assert not props[0].level_ids[:, sam].any()
    drawn = props[1].level_ids[:, sam]
    assert set(torch.unique(drawn).tolist()) <= {0, 1000, 2000} and drawn.any()
