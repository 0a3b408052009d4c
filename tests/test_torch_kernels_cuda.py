"""CUDA kernel tests of the port: they need an NVIDIA GPU with ``nvcc``
(marker ``cuda``) and skip elsewhere. This file imports no JAX, so it also
runs on a host without it:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from wsovod_torch.ops import roi_pool as port

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, dtype, b=2, h=11, w=17, c=64, n=300, seed=0):
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn(b, h, w, c, generator=g).to(dtype)
    img_w, img_h = w * 8.0, h * 8.0
    xy = torch.rand(b, n, 2, generator=g) * img_w - 20
    wh = torch.rand(b, n, 2, generator=g) * img_w * 0.7
    rois = torch.cat([xy, xy + wh], -1)
    rois[:, 0] = torch.tensor([img_w - 10, img_h - 30, img_w + 40, img_h + 50])
    rois[:, 1] = torch.tensor([50.0, 40.0, 20.0, 10.0])  # degenerate
    rois[:, 2] = torch.tensor([4.0, 12.0, 100.0, 60.0])  # .5 boundaries
    valid = torch.rand(b, n, generator=g) > 0.1
    gate = (torch.rand(b, n, generator=g) + 0.5) * valid
    rois = torch.where(valid[..., None], rois, 0.0)
    return feat.to(device), rois.to(device), gate.to(device)


def test_kernel_equals_plain(cuda):
    """Both pool kernels bit-equal to their plain versions in both dtypes
    and on an inner channel chunk, one launch counted per call; float16 and
    non-contiguous features are refused. The loop kernel at a medium size
    (3 branch copies, 600 ROIs per image, routed), rows 1 and 3. Both
    backward kernels against their plain versions to float tolerance."""
    _check_loop_kernel(cuda)
    _check_backward_kernel(cuda)
    _check_loop_backward_kernel(cuda)
    for dtype in (torch.bfloat16, torch.float32):
        feat, rois, gate = _inputs(cuda, dtype)
        for c_base, c_take in ((0, 64), (16, 32)):
            before = port.LAUNCHES
            got = port.roi_pool_gated(feat, rois, gate, c_base, c_take, 7, 0.125)
            torch.cuda.synchronize()
            assert port.LAUNCHES == before + 1
            want = port.roi_pool_gated_plain(feat, rois, gate, c_base, c_take, 7, 0.125)
            assert torch.equal(got, want), (dtype, c_base, c_take)

    feat, rois, gate = _inputs(cuda, torch.float16)
    with pytest.raises(TypeError):
        port.roi_pool_gated(feat, rois, gate, 0, 64)
    feat, rois, gate = _inputs(cuda, torch.bfloat16)
    with pytest.raises(ValueError):
        port.roi_pool_gated(feat.transpose(1, 2), rois, gate, 0, 64)


def _check_backward_kernel(cuda):
    """``roi_pool_gated_bwd`` against ``roi_pool_gated_bwd_plain`` on a
    tie-heavy map (post-ReLU values on a 0.5 grid), both cotangents, both
    dtypes, and through ``RoIPoolGatedFunction``. Tolerance: the kernel sums
    the feature cotangent with float32 atomics in a varying order, so
    |kernel - plain| <= rtol |plain| + 1e-5 max |plain|, rtol 1e-5 in
    float32 and one bfloat16 step (2**-7) in bfloat16; the gate cotangent
    (a block sum in another order) rtol 1e-4."""
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        feat, rois, gate = _inputs(cuda, dtype)
        feat = (torch.round(torch.relu(feat.float()) * 2) / 2).to(dtype).contiguous()
        c_base, c_take = 16, 32
        out = port.roi_pool_gated_plain(feat, rois, gate, c_base, c_take, 7, 0.125)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
        before = port.BWD_LAUNCHES
        got_f, got_g = port.roi_pool_gated_bwd(feat, rois, gate, out, g, c_base, c_take, 7, 0.125)
        torch.cuda.synchronize()
        assert port.BWD_LAUNCHES == before + 1
        want_f, want_g = port.roi_pool_gated_bwd_plain(feat, rois, gate, out, g, c_base, c_take,
                                                       7, 0.125)
        scale = want_f.float().abs().max()
        assert scale > 0
        err = (got_f.float() - want_f.float()).abs()
        assert (err <= rtol * want_f.float().abs() + 1e-5 * scale).all(), (dtype, err.max())
        torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-4 * want_g.abs().max())
        only_gate = port.roi_pool_gated_bwd(feat, rois, gate, out, g, c_base, c_take, 7, 0.125,
                                            need_feat=False)
        assert only_gate[0] is None and torch.allclose(only_gate[1], got_g, rtol=1e-4, atol=1e-6)

        leaf = feat.clone().requires_grad_(True)
        before = (port.LAUNCHES, port.BWD_LAUNCHES)
        y = port.RoIPoolGatedFunction.apply(leaf, rois, gate, c_base, c_take, 7, 0.125)
        (y.float() * g.float()).sum().backward()
        torch.cuda.synchronize()
        assert (port.LAUNCHES, port.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        err = (leaf.grad.float() - want_f.float()).abs()
        assert (err <= rtol * want_f.float().abs() + 1e-5 * scale).all(), (dtype, err.max())


def _check_loop_kernel(cuda):
    b, n_br = 2, 3
    g = torch.Generator().manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        feat, rois, gate = _inputs(cuda, dtype, b=b, h=43, w=66, c=256, n=600)
        feat = torch.cat([feat, feat.flip(1), feat * -0.5], 0).contiguous()  # three copies
        branch = torch.randint(0, n_br, (b, 600), generator=g)
        src = (branch * b + torch.arange(b)[:, None]).to(torch.int32).to(cuda)
        for c_base, c_take, rows in ((0, 256, 3), (64, 128, 1)):
            before = port.LOOP_LAUNCHES
            got = port.roi_loop_pool_gated(feat, rois, gate, src, c_base, c_take, rows, 7, 0.125)
            torch.cuda.synchronize()
            assert port.LOOP_LAUNCHES == before + 1
            want = port.roi_loop_pool_gated_plain(feat, rois, gate, src, c_base, c_take, rows, 7,
                                                  0.125)
            assert torch.equal(got, want), (dtype, c_base, c_take, rows)
    with pytest.raises(TypeError):
        port.roi_loop_pool_gated(feat.half(), rois, gate, src, 0, 64)


def _check_loop_backward_kernel(cuda):
    """``roi_loop_pool_gated_bwd`` against ``roi_loop_pool_gated_bwd_plain``
    at a medium size (3 branch copies, 600 ROIs per image, routed, edge and
    gate-0 rows, one copy post-ReLU on a 0.5 grid so bins tie at 0), both
    cotangents, both dtypes, and through ``RoILoopPoolGatedFunction``.
    Tolerances as ``_check_backward_kernel``'s."""
    b, n, n_br = 2, 600, 3
    g = torch.Generator().manual_seed(3)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        feat, rois, gate = _inputs(cuda, dtype, b=b, h=43, w=66, c=256, n=n)
        f = torch.round(feat.float() * 2) / 2
        feat = torch.cat([f, torch.relu(f.flip(1)), f * -0.5], 0).to(dtype).contiguous()
        gate[:, 3] = 0.0  # a valid box with gate 0
        branch = torch.randint(0, n_br, (b, n), generator=g)
        src = (branch * b + torch.arange(b)[:, None]).to(torch.int32).to(cuda)
        c_base, c_take = 64, 128
        out = port.roi_loop_pool_gated_plain(feat, rois, gate, src, c_base, c_take, 3, 7, 0.125)
        cot = torch.randn(out.shape, generator=g).to(cuda, dtype)
        before = port.LOOP_BWD_LAUNCHES
        got_f, got_g = port.roi_loop_pool_gated_bwd(feat, rois, gate, src, out, cot, c_base, c_take,
                                                    7, 0.125)
        torch.cuda.synchronize()
        assert port.LOOP_BWD_LAUNCHES == before + 1
        want_f, want_g = port.roi_loop_pool_gated_bwd_plain(feat, rois, gate, src, out, cot,
                                                            c_base, c_take, 7, 0.125)
        scale = want_f.float().abs().max()
        assert scale > 0
        err = (got_f.float() - want_f.float()).abs()
        assert (err <= rtol * want_f.float().abs() + 1e-5 * scale).all(), (dtype, err.max())
        torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-4 * want_g.abs().max())

        leaf = feat.clone().requires_grad_(True)
        before = (port.LOOP_LAUNCHES, port.LOOP_BWD_LAUNCHES)
        y = port.RoILoopPoolGatedFunction.apply(leaf, rois, gate, src, c_base, c_take, 3, 7, 0.125,
                                                1.8)
        (y.float() * cot.float()).sum().backward()
        torch.cuda.synchronize()
        assert (port.LOOP_LAUNCHES, port.LOOP_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        err = (leaf.grad.float() - want_f.float()).abs()
        assert (err <= rtol * want_f.float().abs() + 1e-5 * scale).all(), (dtype, err.max())


def test_model_forward_on_cuda(cuda):
    """Narrow models end to end on the card, plain and MRRP: the pooler goes
    through its kernel once per channel chunk, detections are finite."""
    from wsovod_torch import get_cfg
    from wsovod_torch.models import build_model

    cfg = get_cfg()
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIPool"
    cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    cfg.MODEL.ROI_BOX_HEAD.DAN_DIM = [64, 64]
    cfg.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_DIM = 16
    cfg.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.DATA_AWARE = True
    cfg.WSOVOD.INSTANCE_REFINEMENT.REFINE_NUM = 1
    cfg.WSOVOD.INSTANCE_REFINEMENT.REFINE_REG = [True]
    model = build_model(cfg, device=cuda, seed=0)
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 60, (2, 20, 2))
    batch = {
        "images": torch.from_numpy(rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)).to(cuda),
        "image_sizes": torch.tensor([[128, 128], [120, 100]], dtype=torch.int32, device=cuda),
        "sam_boxes": torch.from_numpy(np.concatenate([xy, xy + 40], -1).astype(np.float32)).to(cuda),
        "sam_scores": torch.full((2, 20), 0.7, device=cuda),
        "sam_valid": torch.ones(2, 20, dtype=torch.bool, device=cuda),
    }
    emb = torch.randn(5, 16, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = port.LAUNCHES
    with torch.inference_mode():
        det, probs, boxes = model(batch, embeddings=emb)
    torch.cuda.synchronize()
    assert port.LAUNCHES == before + 1  # R18 res5 has 512 channels: one chunk
    assert torch.isfinite(det.scores[det.valid]).all() and det.valid.any()

    cfg.MODEL.MRRP.MRRP_ON = True
    cfg.MODEL.MRRP.BRANCH_DILATIONS = [1, 2, 4]
    cfg.MODEL.MRRP.MRRP_STAGE = "res5"
    cfg.MODEL.MRRP.TEST_BRANCH_IDX = -1
    cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROILoopPool"
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64], [128, 256], [512, 768]]
    model = build_model(cfg, device=cuda, seed=0)
    before = port.LOOP_LAUNCHES
    with torch.inference_mode():
        det, probs, boxes = model(batch, embeddings=emb)
    torch.cuda.synchronize()
    assert port.LOOP_LAUNCHES == before + 1
    assert torch.isfinite(det.scores[det.valid]).all() and det.valid.any()

    # a train step of the plain model with res5 trainable: one pool and one
    # pool-backward launch per chunk, finite losses, res5 receives gradients
    cfg.MODEL.MRRP.MRRP_ON = False
    cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIPool"
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    cfg.MODEL.BACKBONE.FREEZE_AT = 4
    model = build_model(cfg, device=cuda, seed=0).train()
    batch["gt_classes"] = torch.tensor([[1, 3, 0], [2, 0, 0]], device=cuda)
    batch["gt_valid"] = torch.tensor([[True, True, False], [True, False, False]], device=cuda)
    before = (port.LAUNCHES, port.BWD_LAUNCHES)
    losses = model.forward_train(batch, emb, iteration=5,
                                 generator=torch.Generator(device=cuda).manual_seed(0))
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    assert (port.LAUNCHES, port.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert len(losses) == 5 and all(torch.isfinite(v) for v in losses.values()), losses
    assert model.backbone.res5[0].conv1.weight.grad.abs().sum() > 0

    # the same for MRRP: three rows per chunk, one loop pool and one loop
    # backward launch
    cfg.MODEL.MRRP.MRRP_ON = True
    cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROILoopPool"
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64], [128, 256], [512, 768]]
    model = build_model(cfg, device=cuda, seed=0).train()
    before = (port.LOOP_LAUNCHES, port.LOOP_BWD_LAUNCHES)
    losses = model.forward_train(batch, emb, iteration=5,
                                 generator=torch.Generator(device=cuda).manual_seed(0))
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    assert (port.LOOP_LAUNCHES, port.LOOP_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert len(losses) == 5 and all(torch.isfinite(v) for v in losses.values()), losses
    assert model.backbone.res5[0].conv1.weight.grad.abs().sum() > 0
