"""MRRP inference of the port against ``wsovod_tpu`` on the CPU, and the
VGG16-DC5 detectors'.

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
  ``model.apply(..., train=False)``, with all branches at test and with one;
  with the ``ROIAlignV2`` pooler routed by branch, the ROI heads on the JAX
  package's features and proposals against its ``roi_heads.inference``.
  On the CPU the JAX pooler takes its unfused per-branch path, so no Pallas
  interpret run is involved. Tolerances as the plain slice's: rtol 1e-4, box
  atol 1e-3; validity, classes and ``level_ids`` exactly.
* The int8 inference (both int8 keys) of the tiny MRRP R18, inside
  ``test_mrrp_inference_matches_jax``: against the JAX package's, its pooler
  on the TPU path in interpret mode, on its default and ``WSOVOD_POOL_MAXABS``
  routes, with the tolerances of ``torch_port_common.check_int8_model``;
  the ROILoopPool's chunks are 256 channels, the JAX pooler's.
* The ROILoopPool's maxabs and int8 emissions, rows 1 and 3, and the routed
  ROIPool's, inside ``test_loop_pool_plain_matches_jax``: against the TPU
  kernel (``roi_pool_fused_batched(..., loop_pool=..., src_tbl=...,
  quant=...)``) in interpret mode on clipped boxes with 3x3 bins (its
  interpret trace grows with them), exactly (the routed ROIPool's int8),
  and against the jnp reference pools (7x7) with the quantize formula in
  numpy on the edge boxes of ``routed_pool_inputs``, exactly, float32 and
  bfloat16 (all four).
* The level-routed ROILoopPool (kernel 2.5, ``roi_loop_pool_levels``: each
  ROI on its own FPN level, its frame and context clipped to that level's
  map), inside ``test_loop_pool_plain_matches_jax``: rows 3 against the JAX
  package's multi-level ``ROIPooler`` on the jnp path (the edge boxes of
  ``level_pool_inputs``, ROIs on all four levels, float32 and bfloat16) and
  against ``roi_loop_pool_pallas`` in interpret mode on p5, the padded
  map (clipped boxes, one ROI per grid step, 3x3 bins, float32): exact.
* The weight round trip on the MRRP training tree, and ContextLocNet's
  object miner loaded from it against the JAX package's (rtol 1e-5).

* The VGG16-DC5 detectors, inside the same items: ``VGG16`` plain and MRRP
  against the JAX module (rtol 1e-4); the plain ROIPool routed by branch
  and its backward against the JAX package's MRRP pooler and
  ``_pool_branched_bwd(loop_pool=False)`` (exact; rtol 1e-5); the tiny MRRP
  VGG16's inference (as the MRRP R18's); its freeze stages (``plain1``
  falls through to stage 5, as the JAX optimizer labels it) and weight
  round trip. Its train step is in ``test_torch_train.py``.

Three test items on purpose: many small items queued behind the JAX
package's heavy tests have crashed XLA:CPU, and one more item has moved
the JAX package's two heaviest tests onto one worker back to back, past the
tier-1 time limit (ROADMAP.md, host facts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_common import (
    LEVEL_SCALES, MRRP_VGG_YAML, MRRP_YAML, VGG_YAML, check_int8_model, clip_to_image, embeddings,
    jax_level_pool, jax_pallas_per_level, jax_pool_emissions, jax_reference, jax_stages,
    level_pool_inputs, make_batch, np_quant_scale, np_quantize_tiles, port_levels, random_params,
    routed_pool_inputs, tiny_cfg, torch_model_from_jax,
)
from wsovod_tpu.models.backbones.vgg import VGG16 as JaxVGG16
from wsovod_tpu.ops.pallas.roi_pool_fused import _pool_ad_bwd, _pool_branched_bwd
from wsovod_tpu.ops.roi_pool import roi_loop_pool
from wsovod_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from wsovod_tpu.models.mil_heads import ObjectMiningOutputLayers as JaxObjectMiner
from wsovod_tpu.utils.weight_import import import_vgg16, import_wsovod_model
from wsovod_torch import get_cfg
from wsovod_torch.engine.evaluator import inference_on_dataset
from wsovod_torch.models import build_model
from wsovod_torch.models.backbones import VGG16
from wsovod_torch.models.mil_heads import ObjectMiningOutputLayers
from wsovod_torch.ops.roi_pool import (
    loop_bwd_order, loop_geometry, roi_loop_pool_gated, roi_loop_pool_gated_bwd_plain,
    roi_loop_pool_gated_int8, roi_loop_pool_gated_maxabs, roi_loop_pool_levels,
    roi_loop_pool_levels_plain, roi_pool_gated, roi_pool_gated_bwd_plain, roi_pool_gated_int8,
    roi_pool_gated_maxabs,
)
from wsovod_torch.solver.build import param_labels
from wsovod_torch.structures.instances import Instances
from wsovod_torch.utils.weight_import import backbone_state_dict_from_jax, state_dict_from_jax

RTOL, BOX_ATOL = 1e-4, 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_loop_gated(feat, rois, gate, src, c_base, c_take, scale, dtype):
    """``roi_loop_pool(feat[src[b, n]], rois[b]) * gate`` per ROI, the
    reference's unfused MRRP pooler path: every copy pools every ROI of its
    image, each ROI keeps its copy's rows. ``[3, B, N, 7, 7, c_take]``. Op by
    op, as the reference rounds each bfloat16 product (copies are sliced in
    numpy: a slice of a JAX array compiles a program per index)."""
    b, n = src.shape
    f = feat[..., c_base:c_base + c_take]
    out = np.zeros((3, b, n, 7, 7, c_take), np.float32)
    for i in range(b):
        for s in np.unique(src[i]):
            pooled = roi_loop_pool(jnp.asarray(f[s]).astype(dtype), jnp.asarray(rois[i]), 7,
                                   scale, 1.8)
            pooled = pooled * jnp.asarray(gate[i]).astype(dtype)[None, :, None, None, None]
            sel = src[i] == s
            out[:, i, sel] = np.asarray(pooled.astype(jnp.float32))[:, sel]
    return out


def test_loop_pool_plain_matches_jax():
    """Exact in float32 and bfloat16, on routed branches, edge boxes and a
    channel chunk that starts at 4; ``rows=1`` and ``rows=2`` are the first rows of
    ``rows=3``."""
    scale, c_base, c_take = 0.125, 4, 8
    feat, rois, gate, src = routed_pool_inputs()
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
    _check_routed_pool()
    _check_loop_and_routed_emissions()
    _check_level_loop_pool()


def _check_level_loop_pool():
    """The level-routed ROILoopPool's plain version (the CPU path of
    ``roi_loop_pool_levels``) against the JAX multi-level pooler and, per
    level, ``roi_loop_pool_pallas`` (see the module docstring); rows 1 and 2
    are the first rows of rows 3; a tiny temporary budget gives the same
    bits."""
    feats, rois, gate, valid = level_pool_inputs(2)
    level = port_levels(rois)
    assert len(torch.unique(level)) == len(LEVEL_SCALES)
    wants = jax_level_pool(feats, rois, gate, valid, "ROILoopPool", (jnp.float32, jnp.bfloat16))
    for dtype, want in zip((torch.float32, torch.bfloat16), wants):
        fs = [_t(f).to(dtype) for f in feats]
        got = roi_loop_pool_levels(fs, _t(rois), _t(gate), level, 0, 8, 3, 7, LEVEL_SCALES)
        assert got.dtype == dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=str(dtype))
        for rows in (1, 2):
            part = roi_loop_pool_levels(fs, _t(rois), _t(gate), level, 0, 8, rows, 7,
                                        LEVEL_SCALES)
            assert torch.equal(part, got[:rows])
    # every row pools something on the edge rows, nothing on the invalid one
    assert all((np.abs(want[r, :, :7]).reshape(2, 7, -1).max(-1) > 0).any() for r in range(3))
    assert not want[:, :, 7].any()
    args = ([_t(f) for f in feats], _t(rois), _t(gate), level, 2, 4, 3, 7, LEVEL_SCALES)
    assert torch.equal(roi_loop_pool_levels_plain(*args),
                       roi_loop_pool_levels_plain(*args, max_elems=1))

    # the TPU kernel on p5, the coarsest map, whose padding moves the clip
    # bounds w_lim / scale furthest from the image's (each level costs a
    # trace of the kernel; the jnp reference above holds every level)
    rois_c = clip_to_image(rois, 136.0, 100.0)
    level_c = port_levels(rois_c)
    on = level_c.numpy() == 3
    assert on.sum() >= 2
    want = jax_pallas_per_level(feats, rois_c, gate, level_c.numpy(), loop=True, p=3,
                                levels=(3,))
    got = roi_loop_pool_levels([_t(f) for f in feats], _t(rois_c), _t(gate), level_c, 0, 8, 3, 3,
                               LEVEL_SCALES)
    np.testing.assert_array_equal(got.numpy()[:, on], want[:, on])


def _check_loop_and_routed_emissions():
    """The ROILoopPool's maxabs and int8 emissions (rows 3 and 1) and the
    routed ROIPool's against the TPU kernel in interpret mode, then against
    the jnp reference pools and the formula (see the module docstring)."""
    scale = 0.125
    feat, rois, gate, src = routed_pool_inputs(7, c=256, n=16)
    img_w, img_h = feat.shape[2] / scale, feat.shape[1] / scale
    rois_c = clip_to_image(rois, img_w, img_h)
    f, r, g, s = _t(feat), _t(rois_c), _t(gate), _t(src)
    (want, part), (want_q, want_s), routed = jax_pool_emissions(
        feat, rois_c, gate, [("maxabs", True, True), ("int8", True, True), ("int8", False, True)],
        128, src)
    got, m = roi_loop_pool_gated_maxabs(f, r, g, s, 0, 256, 3, 3, scale, 1.8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(m.numpy(), part.max(axis=(2, 4)))  # [3, B, n_ct, N, lanes]
    got1, m1 = roi_loop_pool_gated_maxabs(f, r, g, s, 0, 256, 1, 3, scale, 1.8)
    assert torch.equal(got1, got[:1]) and torch.equal(m1, m[:1])
    got_q, got_s = roi_loop_pool_gated_int8(f, r, g, s, 0, 256, 128, 3, 3, scale, 1.8)
    assert got_q.dtype == torch.int8 and got_s.shape == (3, 2, 2, 16)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    got1_q, got1_s = roi_loop_pool_gated_int8(f, r, g, s, 0, 256, 128, 1, 3, scale, 1.8)
    assert torch.equal(got1_q, got_q[:1]) and torch.equal(got1_s, got_s[:1])
    # the routed ROIPool (a per-ROI source copy of the branch-major concat):
    # int8 against the TPU kernel; its maxabs, whose payload is the routed
    # gated pool's, against the jnp reference below
    want_q, want_s = routed
    got_q, got_s = roi_pool_gated_int8(f, r, g, 0, 256, 128, 3, scale, s)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)

    # the jnp reference pools (edge boxes included) and the formula
    c_base, c_take, c_tile = 4, 8, 4
    feat, rois, gate, src = routed_pool_inputs(8)
    ones = np.ones_like(gate)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ft, rt, gt, st = _t(feat).to(dtype), _t(rois), _t(gate), _t(src)
        loop = _jax_loop_gated(feat, rois, gate, src, c_base, c_take, scale, jdtype)
        out, m = roi_loop_pool_gated_maxabs(ft, rt, gt, st, c_base, c_take, 3, 7, scale, 1.8)
        np.testing.assert_array_equal(out.float().numpy(), loop)
        np.testing.assert_array_equal(m.numpy(), np.abs(loop).max(axis=(3, 4, 5)))
        q, mt = np_quantize_tiles(_jax_loop_gated(feat, rois, ones, src, c_base, c_take, scale,
                                                  jdtype), c_tile)
        got_q, got_s = roi_loop_pool_gated_int8(ft, rt, gt, st, c_base, c_take, c_tile, 3, 7,
                                                scale, 1.8)
        np.testing.assert_array_equal(got_q.numpy(), q)
        np.testing.assert_array_equal(got_s.numpy(), np_quant_scale(gate[..., None], mt)
                                      .transpose(0, 1, 3, 2))
        routed = _jax_routed_pool(feat, rois, gate, src, c_base, c_take, scale, jdtype)
        out, m = roi_pool_gated_maxabs(ft, rt, gt, c_base, c_take, 7, scale, st)
        np.testing.assert_array_equal(out.float().numpy(), routed)
        np.testing.assert_array_equal(m.numpy(), np.abs(routed).max(axis=(2, 3, 4)))
        q, mt = np_quantize_tiles(_jax_routed_pool(feat, rois, ones, src, c_base, c_take, scale,
                                                   jdtype), c_tile)
        got_q, got_s = roi_pool_gated_int8(ft, rt, gt, c_base, c_take, c_tile, 7, scale, st)
        np.testing.assert_array_equal(got_q.numpy(), q)
        np.testing.assert_array_equal(got_s.numpy(), np_quant_scale(gate[..., None], mt)
                                      .transpose(0, 2, 1))


def _check_loop_backward():
    """The plain backward against ``_pool_branched_bwd`` and
    ``_pool_ad_bwd(loop_pool=True)``, each called with ``out`` from the jnp
    ``roi_loop_pool``: values on a 0.5 grid (ties, exact zeros, negatives),
    one copy post-ReLU (bins whose max is 0), the edge boxes of
    ``routed_pool_inputs`` (overhanging, degenerate, empty holes, wholly outside)
    and gate-0 rows; both cotangents. Then the tie at 0: a 2x2 map of zeros
    pooled into one bin sends each pixel ``g * gate / 2 / 2 / 2`` of the ROI
    row (``jnp.maximum(M, 0)`` halves it, as ``torch.maximum``; a
    ``clamp_min`` would not)."""
    scale, c_base, c_take, b = 0.125, 4, 8, 2
    feat, rois, gate, src = routed_pool_inputs(1)
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

    # the kernel's walk (loop_bwd_order): every ROI of nonzero gate once (a
    # block walks all of a ROI's bins and sets), by feature copy and then the
    # top-left of its region; the ROIs of gate 0 (row 10, the invalid row 9)
    # after them, past n_live, where no block works
    h_lim, w_lim = feat.shape[1:3]
    geo = loop_geometry(torch.from_numpy(rois), scale, h_lim, w_lim, 1.8)
    gate_b = torch.from_numpy(gate).to(torch.bfloat16)
    order, n_live = loop_bwd_order(geo, gate_b, torch.from_numpy(src), h_lim, w_lim)
    live = (gate_b != 0).flatten()
    k = int(n_live)
    assert order.dtype == torch.int32 and n_live.shape == (1,) and k == int(live.sum())
    assert sorted(order.tolist()) == list(range(live.numel()))
    assert live[order[:k].long()].all() and not live[order[k:].long()].any()
    assert not live.view(b, -1)[:, 9:11].any()
    walk = order[:k].long()
    keys = [(int(src.flatten()[i]), min(max(int(geo.view(-1, 16)[i, 1]), 0), h_lim - 1),
             min(max(int(geo.view(-1, 16)[i, 0]), 0), w_lim - 1)) for i in walk]
    assert keys == sorted(keys) and len(set(src.flatten()[walk.numpy()].tolist())) > 1

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
    with its top-5 detections; the ROI heads with all branches and the
    ``ROIAlignV2`` pooler routed by branch. Then the data-aware vector of a
    single-branch batch of three images."""
    _check_single_branch_batch_of_three()
    _check_mrrp_vgg_inference()
    tm = check_int8_model(MRRP_YAML, level_ids=True)
    assert tm.roi_heads.c_take == 256 and tm.roi_heads.box_head.fc1.n_chunks == 2
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
    _check_mrrp_align_heads()


def _check_mrrp_align_heads():
    """The ROI heads of the tiny MRRP R18 with the ``ROIAlignV2`` pooler,
    routed by branch, on the JAX package's features, proposals (with their
    ``level_ids``) and data-aware vector of all three branches (the pooler
    changes nothing before the ROI heads): the port's against the JAX
    package's ``roi_heads.inference``, which pools every branch copy with
    the jnp ``roi_align`` and keeps each ROI's. Probabilities and boxes as
    the forward's (rtol 1e-4, box atol 1e-3), the top-5 detections' classes
    exactly. Then ``inference_on_dataset`` runs the model over two
    batches."""
    from wsovod_tpu.structures.instances import Instances as JaxInstances

    batch = make_batch(0)
    feats, rpn, daf, (_, _, _, props) = jax_stages(0, MRRP_YAML, -1)
    level_ids = np.concatenate([rpn.level_ids, np.zeros_like(batch["sam_valid"], np.int32)], 1)
    assert len(np.unique(level_ids[props[2]] // 1000)) == 3
    jm, params = jax_reference(MRRP_YAML, -1, "ROIAlignV2")

    def heads(m, f, boxes, logits, valid, lv, sizes, d, e):
        p = JaxInstances(valid, proposal_boxes=boxes, objectness_logits=logits, level_ids=lv)
        return m.roi_heads.inference(f, p, sizes, data_aware_features=d, embeddings=e)

    args = (feats, *props[:2], props[2], level_ids, batch["image_sizes"], daf, embeddings())
    det, probs, boxes = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, *a: jm.apply(p, *a, method=heads))(params, *jax.tree_util.tree_map(jnp.asarray,
                                                                                  args)))
    tm = torch_model_from_jax(MRRP_YAML, -1, "ROIAlignV2")
    assert tm.roi_heads.pooler.pooler_type == "ROIAlignV2"
    jprops = Instances(torch.from_numpy(props[2]), proposal_boxes=torch.from_numpy(props[0]),
                       objectness_logits=torch.from_numpy(props[1]),
                       level_ids=torch.from_numpy(level_ids))
    with torch.inference_mode():
        tdet, tprobs, tboxes = tm.roi_heads.inference(
            {k: torch.from_numpy(v) for k, v in feats.items()}, jprops,
            torch.from_numpy(batch["image_sizes"]), data_aware_features=torch.from_numpy(daf),
            embeddings=torch.from_numpy(embeddings()))
    np.testing.assert_allclose(tprobs.numpy(), probs, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tboxes.numpy(), boxes, rtol=RTOL, atol=BOX_ATOL)
    for i in range(2):
        v = det.valid[i]
        top = np.argsort(np.where(v, -det.scores[i], np.inf), kind="stable")[:5]
        assert len(top[v[top]]) == 5
        np.testing.assert_array_equal(tdet.classes[i].numpy()[top], det.classes[i][top])
        np.testing.assert_allclose(tdet.scores[i].numpy()[top], det.scores[i][top], rtol=RTOL)

    # the entry point runs the model over two batches: finite detections
    class Count:
        rows = {}

        def process(self, image_id, boxes, scores, classes):
            assert np.isfinite(boxes).all() and np.isfinite(scores).all()
            self.rows[image_id] = len(scores)

        def evaluate(self):
            return dict(self.rows)

    def loader():
        for seed in (0, 1):
            b = make_batch(seed)
            b["image_id"] = [f"{seed}_{i}" for i in range(2)]
            b["orig_size"] = b["image_sizes"]
            yield b

    got = inference_on_dataset(tm, loader(), Count(), embeddings=torch.from_numpy(embeddings()))
    assert len(got) == 4 and min(got.values()) > 0


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
    want = jax.jit(lambda p, f, v: jm.apply(
        p, f, v, method=lambda m, f, v: m.data_aware_head(f, pixel_valid=v)))(
        params, jnp.asarray(feat.numpy()), jnp.asarray(valid))
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
    classes = (5, 1)
    wants = jax.jit(lambda jp, x, v: [  # both class counts in one compiled program
        JaxObjectMiner(num_classes=c, context=True).apply(
            jax.tree_util.tree_map(lambda a: a[..., :c], jp), x, v) for c in classes])(
        jparams, jnp.asarray(x), jnp.asarray(valid))
    for c, want in zip(classes, wants):
        want = np.asarray(want)
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
    _check_vgg_backbone()
    _check_vgg_freeze_stages_and_weights()


# ---------------------------------------------------------------- VGG16-DC5
def _check_vgg_backbone():
    """``VGG16`` against the JAX package's ``VGG16.apply`` on a 1x3x48x64
    image, train and test mode, rtol 1e-4 (float32 convs summed in another
    order over 13 layers): plain (plain5 at dilation 2 after plain4's
    unpadded stride-1 pool: 48x64 gives 5x7) and MRRP (dilations 1/2/4, test
    branch 1: three copies in training, one at test)."""
    x = np.random.RandomState(0).randn(1, 48, 64, 3).astype(np.float32) * 50
    for mrrp in (False, True):
        kw = dict(conv5_dilation=2, out_features=("plain5",))
        if mrrp:
            kw.update(mrrp_on=True, mrrp_dilations=(1, 2, 4), mrrp_stage="plain5",
                      mrrp_test_branch_idx=1)
        jm = JaxVGG16(**kw)
        params = random_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                              jnp.asarray(x))), seed=3)
        tm = VGG16(**kw)
        tm.load_state_dict(backbone_state_dict_from_jax(params["params"]), strict=True)
        modes = (False, True)
        wants = jax.jit(lambda p, v: [jm.apply(p, v, train=train)["plain5"] for train in modes])(
            params, jnp.asarray(x))  # both modes in one compiled program
        for train, want in zip(modes, wants):
            want = np.asarray(want)
            with torch.inference_mode():
                got = tm(_t(x), train=train)["plain5"].numpy()
            copies = 3 if mrrp and train else 1
            assert got.shape == want.shape == (copies, 5, 7, 512), (mrrp, train, got.shape)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                                       err_msg=f"mrrp {mrrp}, train {train}")
            assert np.abs(want).max() > 0


def _jax_routed_pool(feat, rois, gate, src, c_base, c_take, scale, dtype):
    """The JAX package's MRRP ROIPool: every copy of image ``b`` pools all
    of its ROIs, each ROI keeps its branch's, times the gate (op by op;
    copies sliced in numpy, as ``_jax_loop_gated``)."""
    b, n = src.shape
    n_br = feat.shape[0] // b
    f = feat[..., c_base:c_base + c_take]
    out = []
    for i in range(b):
        pooled = jnp.stack([jax_roi_pool(jnp.asarray(f[br * b + i]).astype(dtype),
                                         jnp.asarray(rois[i]), 7, scale) for br in range(n_br)])
        sel = jnp.asarray(src[i] // b)[None, :, None, None, None]
        pooled = jnp.take_along_axis(pooled, sel, axis=0)[0]
        out.append(pooled * jnp.asarray(gate[i]).astype(dtype)[:, None, None, None])
    return np.asarray(jnp.stack(out).astype(jnp.float32))


def _check_routed_pool():
    """The plain ROIPool routed by branch (``roi_pool_gated`` with ``src``)
    against the JAX package's MRRP pooler path
    (``wsovod_tpu/models/poolers.py:808-840``: the jnp ``roi_pool`` of every
    copy, ``take_along_axis`` by branch, times the gate), exact in float32
    and bfloat16, with overhanging, degenerate, wholly outside and invalid
    boxes; its backward (``roi_pool_gated_bwd_plain`` with ``src``) against
    the JAX package's ``_pool_branched_bwd(loop_pool=False)`` called
    directly, on tie-heavy float32 features (a 0.5 grid, every other copy
    post-ReLU) with gate-0 rows, both cotangents, rtol 1e-5 (float32
    summation order)."""
    scale, c_base, c_take, b = 0.125, 4, 8, 2
    feat, rois, gate, src = routed_pool_inputs(2)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = _jax_routed_pool(feat, rois, gate, src, c_base, c_take, scale, jdtype)
        got = roi_pool_gated(_t(feat).to(dtype), _t(rois), _t(gate), c_base, c_take, 7, scale,
                             _t(src))
        assert got.dtype == dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=str(dtype))
    assert (np.abs(want[:, :8]).reshape(b, 8, -1).max(-1) > 0).all()  # the edge rows pool
    assert not want[:, 8].any() and not want[:, 9].any()  # wholly outside; invalid

    # the backward, on ties: a 0.5 grid, every other copy post-ReLU
    feat = np.round(feat * 2) / 2
    feat[1::b] = np.maximum(feat[1::b], 0)
    feat = feat.astype(np.float32)
    gate[:, 10] = 0.0  # a valid box with gate 0
    out = _jax_routed_pool(feat, rois, gate, src, c_base, c_take, scale, jnp.float32)
    g = np.random.RandomState(4).randn(*out.shape).astype(np.float32)
    hwnc = (0, 2, 3, 1, 4)  # the TPU kernel's [B, P, P, N, c] layout
    args = (c_base, c_take, 7, scale, False, 1.8, None, False, None)
    res = (jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(gate),
           jnp.asarray((src // b).astype(np.float32)), jnp.asarray(out.transpose(hwnc)))
    want_feat, _, want_gate, _ = jax.jit(lambda res, g: _pool_branched_bwd(*args, res, g))(
        res, jnp.asarray(g.transpose(hwnc)))
    got_feat, got_gate = roi_pool_gated_bwd_plain(_t(feat), _t(rois), _t(gate), _t(out), _t(g),
                                                  c_base, c_take, 7, scale, src=_t(src))
    np.testing.assert_allclose(got_feat.numpy(), want_feat, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_gate.numpy(), want_gate, rtol=1e-5, atol=1e-5)
    assert got_feat.shape == feat.shape and np.abs(want_feat).max() > 0
    assert (got_gate.numpy()[:, 10] == 0).all()
    assert not got_feat[..., :c_base].any() and not got_feat[..., c_base + c_take:].any()
    # every copy is read, and each ROI's cotangent lands in its own copy only
    assert all(np.abs(want_feat[s]).max() > 0 for s in range(feat.shape[0]))


def _check_vgg_freeze_stages_and_weights():
    """The freeze stages of the MRRP VGG16: ``plain1`` matches none of the
    JAX package's stage rules and falls through to stage 5, so ``FREEZE_AT``
    4 trains plain1 and plain5 (labels equal to the JAX optimizer's); the
    conv biases start at zero; and the weight round trip through the
    reference torch names ``backbone.plain{k}.conv{i}``."""
    from wsovod_tpu.solver.build import param_labels as jax_param_labels

    _, template = jax_reference(MRRP_VGG_YAML, -1)
    model = build_model(tiny_cfg(get_cfg(), MRRP_VGG_YAML), device="cpu", seed=0)
    plain = build_model(tiny_cfg(get_cfg(), VGG_YAML), device="cpu", seed=None)
    assert sorted(model.state_dict()) == sorted(plain.state_dict())
    # init_parameters zeroes the conv biases, as the JAX package's ConvNorm
    assert not model.backbone.plain1.conv1.bias.any() and model.backbone.plain1.conv1.weight.std() > 0

    jax_labels = {jax.tree_util.keystr(path): label for path, label in
                  jax.tree_util.tree_flatten_with_path(jax_param_labels(template["params"], 4))[0]}
    for freeze_at, trainable in ((4, {"plain1", "plain5"}), (5, set())):
        cfg = tiny_cfg(get_cfg(), MRRP_VGG_YAML)
        cfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
        built = build_model(cfg, device="cpu", seed=None)
        assert {n.split(".")[1] for n, p in built.named_parameters()
                if n.startswith("backbone.") and p.requires_grad} == trainable
        for name, label in param_labels(built).items():
            if not name.startswith("backbone."):
                continue
            block, conv, leaf = name.split(".")[1:]
            assert label == ("backbone" if block in trainable else "frozen"), (name, freeze_at)
            if freeze_at == 4:  # the JAX optimizer's label of the same tensor
                key = f"['backbone']['{block}']['{conv}']['{'kernel' if leaf == 'weight' else 'bias'}']"
                assert jax_labels[key] == label, (name, jax_labels[key])

    # reference-named blobs -> the JAX importers -> back: bit-equal, strict
    rng = np.random.RandomState(5)
    blobs = {k: rng.randn(*v.shape).astype(np.float32) for k, v in model.state_dict().items()}
    heads = {k: v for k, v in blobs.items() if not k.startswith("backbone.")}
    tree = import_wsovod_model(heads, template, pooled_shape=(512, 7, 7))
    tree["params"]["backbone"] = import_vgg16(blobs, prefix="backbone.")
    back = state_dict_from_jax(tree)
    assert sorted(back) == sorted(blobs)
    for k, v in blobs.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    model.load_state_dict(back, strict=True)


def _check_mrrp_vgg_inference():
    """The tiny MRRP VGG16 (``configs/COCO-Detection/WSOVOD_MRRP_V_16_DC5_1x
    .yaml`` with ``tiny_cfg``: DAN 64, 16-dim embeddings, 5 classes, RPN
    top-k 64/16, ``RPN.IN_FEATURES ["plain5"]``) on the JAX parameters
    through ``state_dict_from_jax``, against ``model.apply(...,
    train=False)``: plain5, the RPN's group proposals with their
    ``level_ids``, the forward and its top-5 detections (rtol 1e-4, box atol
    1e-3; validity, classes and ``level_ids`` exactly)."""
    feats, rpn, daf, (det, probs, boxes, props) = jax_stages(0, MRRP_VGG_YAML, -1)
    tm = torch_model_from_jax(MRRP_VGG_YAML, -1)
    batch = {k: _t(v) for k, v in make_batch(0).items()}
    with torch.inference_mode():
        tfeats = tm.backbone(tm._normalize(batch["images"]))
        trpn = tm.proposal_generator(tfeats, batch["image_sizes"])
        tdet, tprobs, tboxes, tprops = tm(batch, embeddings=_t(embeddings()), return_proposals=True)
    assert tfeats["plain5"].shape == feats["plain5"].shape == (6, 7, 7, 512)
    np.testing.assert_allclose(tfeats["plain5"].numpy(), feats["plain5"], rtol=RTOL,
                               atol=RTOL * np.abs(feats["plain5"]).max())
    np.testing.assert_array_equal(trpn.valid.numpy(), rpn.valid)
    np.testing.assert_array_equal(trpn.level_ids.numpy(), rpn.level_ids)
    np.testing.assert_allclose(trpn.proposal_boxes.numpy(), rpn.proposal_boxes, rtol=RTOL,
                               atol=BOX_ATOL)
    assert len(np.unique(rpn.level_ids[rpn.valid] // 1000)) == 3
    np.testing.assert_array_equal(tprops[2].numpy(), props[2])
    np.testing.assert_allclose(tprops[0].numpy(), props[0], rtol=RTOL, atol=BOX_ATOL)
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
        np.testing.assert_allclose(tdet.boxes[i].numpy()[top], det.boxes[i][top], rtol=RTOL,
                                   atol=BOX_ATOL)
