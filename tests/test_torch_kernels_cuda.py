"""CUDA kernel tests of the port: they need an NVIDIA GPU with ``nvcc``
(marker ``cuda``) and skip elsewhere. This file imports no JAX, so it also
runs on a host without it:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import os

import numpy as np
import pytest
import torch

from wsovod_torch.ops import roi_align as align
from wsovod_torch.ops import roi_pool as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    backward kernels against their plain versions to float tolerance. The
    gated ROIPool and its backward routed by a per-ROI source copy. The
    gated ROIAlign and its backward. The emission modes (maxabs, int8,
    tile8; the align's int8) bit-equal to their plain versions, payloads and
    scales, one launch counted per call. The level-routed ROIPool and
    ROILoopPool (kernel 2.5) bit-equal to their plain versions. The 2.9
    walks (row fold, bin row walk) bit-equal to their plain versions."""
    _check_walk_kernels(cuda)
    _check_level_kernels(cuda)
    _check_emission_kernels(cuda)
    _check_align_kernels(cuda)
    _check_loop_kernel(cuda)
    _check_backward_kernel(cuda)
    _check_loop_backward_kernel(cuda)
    _check_routed_kernels(cuda)
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


def _check_walk_kernels(cuda):
    """Kernel 2.9 at narrow shapes: the row fold in float32, bfloat16 and
    int8 (an int8 window column of all -128 folds to -127) with the default
    and other counts, and the bin row walk in cases A-F (an int8 column of
    all -128 widens to -128), bit-equal to their plain versions, one launch
    counted per call; float16 and non-contiguous maps are refused."""
    from wsovod_torch.scripts import bench_i8walk as walk
    from wsovod_torch.scripts import bench_vpu_pack as fold

    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        feat = fold.make_map(dtype, cuda, seed=1, shape=(30, 72, 64))
        if dtype == torch.int8:
            feat[:, int(fold.origins(fold.NROI, 30, 72, fold.ROWS, fold.WIN)[1][-1]) + 3] = -128
        for kw in ({"n_roi": 5, "rows": 7, "win": 16, "steps": 3}, {}):
            before = fold.LAUNCHES
            got = fold.row_fold(feat, **kw)
            torch.cuda.synchronize()
            assert fold.LAUNCHES == before + 1
            assert torch.equal(got, fold.row_fold_plain(feat, **kw)), (dtype, kw)
        if dtype == torch.int8:  # the default counts' last window holds the -128 column
            assert (got[:, 3] == -127).all()
    with pytest.raises(TypeError):
        fold.row_fold(fold.make_map(torch.float16, cuda, shape=(30, 72, 64)))
    with pytest.raises(ValueError):
        fold.row_fold(feat.repeat(1, 1, 2)[..., :64])  # not contiguous

    feats, hlo, x0 = walk.make_inputs(cuda, h=12, w=104, c=64, nb=2)
    feats["int8"][0, :, 3] = -128
    for name, dt, win in walk.CASES:
        before = walk.LAUNCHES
        got = walk.row_walk(feats[dt], hlo, x0[name], win)
        torch.cuda.synchronize()
        assert walk.LAUNCHES == before + 1
        assert torch.equal(got, walk.row_walk_plain(feats[dt], hlo, x0[name], win)), name
    with pytest.raises(TypeError):
        walk.row_walk(feats["bf16"].half(), hlo, x0["C bf16 win48  "], 48)
    with pytest.raises(ValueError):
        walk.row_walk(feats["bf16"].repeat(1, 1, 1, 2)[..., :64], hlo, x0["C bf16 win48  "], 48)


def _check_level_kernels(cuda):
    """``roi_pool_levels`` and ``roi_loop_pool_levels`` (rows 1 and 3) on
    four FPN levels of a 344x528 image (p2 ``[2, 86, 132, 64]`` down to p5
    ``[2, 11, 17, 64]``, padded as the Swin FPN pads), 600 ROIs per image on
    all levels with overhanging, degenerate and gate-0 rows, bfloat16 and
    float32, on the whole chunk and an inner one: bit-equal to their plain
    versions, one launch counted per call."""
    from wsovod_torch.models.poolers import assign_boxes_to_levels

    scales = (0.25, 0.125, 0.0625, 0.03125)
    g = torch.Generator().manual_seed(7)
    for dtype in (torch.bfloat16, torch.float32):
        _, rois, gate = _inputs(cuda, dtype, b=2, h=43, w=66, c=8, n=600, seed=7)
        rois = rois * 1.5  # boxes of 8 to 530 px: every level
        gate[:, 5] = 0.0
        shapes, h, w = [], 86, 132
        for _ in scales:
            shapes.append((2, h, w, 64))
            h, w = -(-h // 2), -(-w // 2)
        feats = [torch.randn(sh, generator=g).to(cuda, dtype) for sh in shapes]
        level = assign_boxes_to_levels(rois, 2, 5)
        assert len(torch.unique(level)) == 4
        for c_base, c_take in ((0, 64), (16, 32)):
            before = port.LEVEL_LAUNCHES
            got = port.roi_pool_levels(feats, rois, gate, level, c_base, c_take, 7, scales)
            torch.cuda.synchronize()
            assert port.LEVEL_LAUNCHES == before + 1
            want = port.roi_pool_levels_plain(feats, rois, gate, level, c_base, c_take, 7, scales)
            assert torch.equal(got, want), (dtype, c_base, c_take)
            for rows in (1, 3):
                before = port.LOOP_LEVEL_LAUNCHES
                got = port.roi_loop_pool_levels(feats, rois, gate, level, c_base, c_take, rows, 7,
                                                scales)
                torch.cuda.synchronize()
                assert port.LOOP_LEVEL_LAUNCHES == before + 1
                want = port.roi_loop_pool_levels_plain(feats, rois, gate, level, c_base, c_take,
                                                       rows, 7, scales)
                assert torch.equal(got, want), (dtype, c_base, c_take, rows)
    with pytest.raises(TypeError):
        port.roi_pool_levels([f.half() for f in feats], rois, gate, level, 0, 64, 7, scales)


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


def _assert_near(got, want, rtol, what):
    """|got - want| <= rtol |want| + 1e-5 max |want|: float32 sums in
    another order (atomics in a varying one), rtol 1e-5 in float32 and one
    bfloat16 step (2**-7) where the result is rounded to bfloat16."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max()
    assert scale > 0 and (err <= rtol * want.float().abs() + 1e-5 * scale).all(), (
        what, err.max().item(), scale.item())


def _check_align_kernels(cuda):
    """``roi_align_gated`` and ``roi_align_gated_bwd`` against their plain
    versions: exact ROIAlignV2 (``sampling_ratio`` 1 and 2), ROIAlign
    (``aligned`` false), routed by a per-ROI source copy (3 copies), and the
    windowed mode (the forward); an inner channel chunk; both dtypes; both
    cotangents, and through ``RoIAlignGatedFunction``; one launch counted
    per call. Tolerance as ``_assert_near``; the gate cotangent rtol 1e-4."""
    b, n, n_br = 2, 300, 3
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        feat, rois, gate = _inputs(cuda, dtype)
        gate[:, 5] = 0.0
        copies = torch.cat([feat, -feat, feat * 2]).contiguous()
        branch = torch.randint(0, n_br, (b, n), generator=torch.Generator().manual_seed(3))
        src = (branch * b + torch.arange(b)[:, None]).to(cuda, torch.int32)
        c_base, c_take = 16, 32
        for s, aligned, f, sr, window in ((2, True, feat, None, None), (1, True, feat, None, None),
                                          (2, False, feat, None, None),
                                          (2, True, copies, src, None), (2, True, feat, None, 8)):
            what = (dtype, s, aligned, sr is not None, window)
            args = (rois, gate, c_base, c_take, 7, 0.125, s, aligned)
            before = align.LAUNCHES
            got = align.roi_align_gated(f, *args, src=sr, window=window)
            torch.cuda.synchronize()
            assert align.LAUNCHES == before + 1
            want = align.roi_align_gated_plain(f, *args, src=sr, window=window)
            assert got.dtype == dtype
            _assert_near(got, want, rtol, what)
            if window is not None:
                continue
            g = torch.randn(want.shape, generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
            before = align.BWD_LAUNCHES
            got_f, got_g = align.roi_align_gated_bwd(f, rois, gate, want, g, *args[2:], src=sr)
            torch.cuda.synchronize()
            assert align.BWD_LAUNCHES == before + 1
            want_f, want_g = align.roi_align_gated_bwd_plain(f, rois, gate, want, g, *args[2:],
                                                             src=sr)
            _assert_near(got_f, want_f, rtol, what)
            torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-4 * want_g.abs().max())
            assert (got_g[:, 5] == 0).all()
            leaf = f.clone().requires_grad_(True)
            before = (align.LAUNCHES, align.BWD_LAUNCHES)
            y = align.RoIAlignGatedFunction.apply(leaf, *args, sr)
            (y.float() * g.float()).sum().backward()
            torch.cuda.synchronize()
            assert (align.LAUNCHES, align.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
            _assert_near(leaf.grad, want_f, rtol, what)
    feat, rois, gate = _inputs(cuda, torch.float16)
    with pytest.raises(TypeError):
        align.roi_align_gated(feat, rois, gate, 0, 64)


def _check_routed_kernels(cuda):
    """``roi_pool_gated`` and ``roi_pool_gated_bwd`` with ``src`` (3 branch
    copies, 600 ROIs per image, routed; one copy post-ReLU on a 0.5 grid so
    bins tie, gate-0 rows) against their plain versions: the forward bit for
    bit, the backward to ``_check_backward_kernel``'s tolerances, also
    through ``RoIPoolGatedFunction``."""
    b, n, n_br = 2, 600, 3
    g = torch.Generator().manual_seed(5)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        feat, rois, gate = _inputs(cuda, dtype, b=b, h=43, w=66, c=256, n=n, seed=5)
        f = torch.round(feat.float() * 2) / 2
        feat = torch.cat([f, torch.relu(f.flip(1)), f * -0.5], 0).to(dtype).contiguous()
        gate[:, 3] = 0.0
        branch = torch.randint(0, n_br, (b, n), generator=g)
        src = (branch * b + torch.arange(b)[:, None]).to(torch.int32).to(cuda)
        c_base, c_take = 64, 128
        before = port.LAUNCHES
        out = port.roi_pool_gated(feat, rois, gate, c_base, c_take, 7, 0.125, src)
        torch.cuda.synchronize()
        assert port.LAUNCHES == before + 1
        want = port.roi_pool_gated_plain(feat, rois, gate, c_base, c_take, 7, 0.125, src=src)
        assert torch.equal(out, want), dtype
        cot = torch.randn(out.shape, generator=g).to(cuda, dtype)
        before = port.BWD_LAUNCHES
        got_f, got_g = port.roi_pool_gated_bwd(feat, rois, gate, out, cot, c_base, c_take, 7,
                                               0.125, src=src)
        torch.cuda.synchronize()
        assert port.BWD_LAUNCHES == before + 1 and got_f.shape == feat.shape
        want_f, want_g = port.roi_pool_gated_bwd_plain(feat, rois, gate, out, cot, c_base, c_take,
                                                       7, 0.125, src=src)
        scale = want_f.float().abs().max()
        assert scale > 0 and all(want_f[k].abs().max() > 0 for k in range(feat.shape[0]))
        err = (got_f.float() - want_f.float()).abs()
        assert (err <= rtol * want_f.float().abs() + 1e-5 * scale).all(), (dtype, err.max())
        torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-4 * want_g.abs().max())

        leaf = feat.clone().requires_grad_(True)
        y = port.RoIPoolGatedFunction.apply(leaf, rois, gate, c_base, c_take, 7, 0.125, src)
        (y.float() * cot.float()).sum().backward()
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
    cotangents, both dtypes, and through ``RoILoopPoolGatedFunction``; the
    cases its design treats apart: all-zero rectangles larger than a bin in
    two copies (whole sets tie at 0), one hot pixel that 30 ROIs of one copy
    cover, a ROI whose outer box covers the whole map; the single-copy call
    (``src`` the image); every ``need_feat``/``need_gate`` combination; bins
    wider than 32 columns in every grid and set. Tolerances as
    ``_check_backward_kernel``'s."""
    b, n, n_br = 2, 600, 3
    g = torch.Generator().manual_seed(3)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        feat, rois, gate = _inputs(cuda, dtype, b=b, h=43, w=66, c=256, n=n)
        f = torch.round(feat.float() * 2) / 2
        feat = torch.cat([f, torch.relu(f.flip(1)), f * -0.5], 0)
        feat[1, 5:25, 10:40] = 0.0  # dead areas larger than a bin
        feat[2, 20:40, 30:60] = 0.0
        feat[0, 20, 30] = 50.0  # a hot pixel ...
        side = torch.linspace(24.0, 200.0, 30, device=cuda)[:, None]
        rois[0, 10:40] = torch.tensor([244.0, 164.0, 244.0, 164.0], device=cuda) + side * torch.tensor(
            [-1.0, -0.6, 0.8, 1.0], device=cuda)  # ... that 30 ROIs of copy 0 cover
        gate[0, 10:40] = 1.25
        rois[:, 4] = torch.tensor([0.0, 0.0, 66 * 8.0, 43 * 8.0], device=cuda)  # the whole map
        gate[:, 4] = 0.75
        feat = feat.to(dtype).contiguous()
        gate[:, 3] = 0.0  # a valid box with gate 0
        branch = torch.randint(0, n_br, (b, n), generator=g)
        branch[0, 10:40] = 0
        src = (branch * b + torch.arange(b)[:, None]).to(torch.int32).to(cuda)
        image = torch.arange(b, dtype=torch.int32, device=cuda)[:, None].expand(b, n).contiguous()
        c_base, c_take = 64, 128
        for f_, s_ in ((feat, src), (feat[:b].contiguous(), image)):
            out = port.roi_loop_pool_gated_plain(f_, rois, gate, s_, c_base, c_take, 3, 7, 0.125)
            cot = torch.randn(out.shape, generator=g).to(cuda, dtype)
            before = port.LOOP_BWD_LAUNCHES
            got_f, got_g = port.roi_loop_pool_gated_bwd(f_, rois, gate, s_, out, cot, c_base,
                                                        c_take, 7, 0.125)
            torch.cuda.synchronize()
            assert port.LOOP_BWD_LAUNCHES == before + 1
            want_f, want_g = port.roi_loop_pool_gated_bwd_plain(f_, rois, gate, s_, out, cot,
                                                                c_base, c_take, 7, 0.125)
            what = (dtype, f_.shape[0])
            _assert_near(got_f, want_f, rtol, what)
            assert all(want_f[k].abs().max() > 0 for k in range(f_.shape[0])), what
            torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-4 * want_g.abs().max())
            for need_feat, need_gate in ((True, False), (False, True), (False, False)):
                before = port.LOOP_BWD_LAUNCHES
                part = port.roi_loop_pool_gated_bwd(f_, rois, gate, s_, out, cot, c_base, c_take, 7,
                                                    0.125, need_feat=need_feat, need_gate=need_gate)
                torch.cuda.synchronize()
                assert port.LOOP_BWD_LAUNCHES == before + 1
                assert (part[0] is None) != need_feat and (part[1] is None) != need_gate
                if need_feat:
                    _assert_near(part[0], want_f, rtol, what)
                if need_gate:
                    assert torch.allclose(part[1], got_g, rtol=1e-4, atol=1e-6), what

        leaf = feat.clone().requires_grad_(True)
        before = (port.LOOP_LAUNCHES, port.LOOP_BWD_LAUNCHES)
        y = port.RoILoopPoolGatedFunction.apply(leaf, rois, gate, src, c_base, c_take, 3, 7, 0.125,
                                                1.8)
        cot = torch.randn(y.shape, generator=g).to(cuda, dtype)
        (y.float() * cot.float()).sum().backward()
        torch.cuda.synchronize()
        assert (port.LOOP_LAUNCHES, port.LOOP_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        want_f, _ = port.roi_loop_pool_gated_bwd_plain(feat, rois, gate, src, None, cot, c_base,
                                                       c_take, 7, 0.125, need_gate=False)
        _assert_near(leaf.grad, want_f, rtol, dtype)

        # bins wider than 32 columns, more than a row's mask holds: a band of
        # 6 rows by 240 columns, half the ROIs over 224 columns wide (the
        # ROI's and the frame's bins), half 137-175 columns wide about the
        # middle (their outer boxes, the context's bins, span the map); copy
        # 0 has a row tied at every column, copy 1 a dead area; rows 3 and 1
        k = 40
        wide = torch.round(torch.relu(torch.randn(b, 6, 240, 64, generator=g)) * 2) / 2
        wide[0, 3] = 8.0
        wide[1, :, 60:200] = 0.0
        wide = wide.to(cuda, dtype).contiguous()
        half = torch.arange(k) < k // 2
        span = 1100 + torch.rand(b, k, generator=g) * 300
        x1 = torch.where(half, torch.rand(b, k, generator=g) * 56,
                         900 + torch.rand(b, k, generator=g) * 120 - span / 2)
        x2 = torch.where(half, 1864 + torch.rand(b, k, generator=g) * 56, x1 + span)
        ys = torch.rand(b, k, 2, generator=g).sort(-1).values * 48
        w_rois = torch.stack([x1, ys[..., 0], x2, ys[..., 1]], -1).to(cuda)
        w_gate = (torch.rand(b, k, generator=g) + 0.5).to(cuda)
        w_gate[:, 7] = 0.0
        w_src = image[:, :k].contiguous()
        geo = port.loop_geometry(w_rois, 0.125, 6, 240, 1.8)
        assert (geo[:, :k // 2, 2] > 224).all() and (geo[:, k // 2:, 6] > 224).all()
        out = port.roi_loop_pool_gated_plain(wide, w_rois, w_gate, w_src, 0, 64, 3, 7, 0.125)
        cot = torch.randn(out.shape, generator=g).to(cuda, dtype)
        for rows in (3, 1):
            o_r, c_r = out[:rows].contiguous(), cot[:rows].contiguous()
            got_f, got_g = port.roi_loop_pool_gated_bwd(wide, w_rois, w_gate, w_src, o_r, c_r, 0,
                                                        64, 7, 0.125)
            want_f, want_g = port.roi_loop_pool_gated_bwd_plain(wide, w_rois, w_gate, w_src, o_r,
                                                                c_r, 0, 64, 7, 0.125)
            _assert_near(got_f, want_f, rtol, (dtype, "wide", rows))
            torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-4 * want_g.abs().max())


def _check_emission_kernels(cuda):
    """Every emission kernel against its plain version, bfloat16 and
    float32, unrouted and routed (three copies), rows 1 and 3."""
    counters = ("MAXABS_LAUNCHES", "INT8_LAUNCHES", "TILE8_LAUNCHES", "LOOP_MAXABS_LAUNCHES",
                "LOOP_INT8_LAUNCHES")
    for dtype in (torch.bfloat16, torch.float32):
        feat, rois, gate = _inputs(cuda, dtype, c=128)
        three = torch.cat([feat, -feat, feat * 2]).contiguous()
        src = (torch.arange(2, device=cuda)[:, None]
               + 2 * (torch.arange(rois.shape[1], device=cuda) % 3)[None]).to(torch.int32)
        before = [getattr(port, c) for c in counters] + [align.INT8_LAUNCHES]
        cases = [
            (port.roi_pool_gated_maxabs, port.roi_pool_gated_maxabs_plain,
             (feat, rois, gate, 32, 64, 7, 0.125)),
            (port.roi_pool_gated_maxabs, port.roi_pool_gated_maxabs_plain,
             (three, rois, gate, 0, 128, 7, 0.125, src)),
            (port.roi_pool_gated_int8, port.roi_pool_gated_int8_plain,
             (feat, rois, gate, 0, 128, 64, 7, 0.125)),
            (port.roi_pool_gated_int8, port.roi_pool_gated_int8_plain,
             (three, rois, gate, 0, 128, 32, 7, 0.125, src)),
            (port.roi_pool_gated_tile8, port.roi_pool_gated_tile8_plain,
             (feat, rois, gate, 64, 64, 7, 0.125)),
            (port.roi_loop_pool_gated_maxabs, port.roi_loop_pool_gated_maxabs_plain,
             (three, rois, gate, src, 0, 128, 3, 7, 0.125)),
            (port.roi_loop_pool_gated_maxabs, port.roi_loop_pool_gated_maxabs_plain,
             (three, rois, gate, src, 64, 64, 1, 7, 0.125)),
            (port.roi_loop_pool_gated_int8, port.roi_loop_pool_gated_int8_plain,
             (three, rois, gate, src, 0, 128, 64, 3, 7, 0.125)),
            (align.roi_align_gated_int8, align.roi_align_gated_int8_plain,
             (feat, rois, gate, 0, 128, 64, 7, 0.125, 2)),
            (align.roi_align_gated_int8, align.roi_align_gated_int8_plain,
             (three, rois, gate, 0, 128, 128, 7, 0.125, 2, True, src, align.WINDOW)),
        ]
        for kernel, plain, args in cases:
            got, want = kernel(*args), plain(*args)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (kernel.__name__, dtype)
        torch.cuda.synchronize()
        after = [getattr(port, c) for c in counters] + [align.INT8_LAUNCHES]
        assert [a - b for a, b in zip(after, before)] == [2, 2, 1, 2, 1, 2], (before, after)
        # the maxabs payload is the gated pool's bit for bit
        assert torch.equal(port.roi_pool_gated_maxabs(*cases[0][2])[0],
                           port.roi_pool_gated(*cases[0][2]))


def test_model_forward_on_cuda(cuda):
    """Narrow models end to end on the card, plain and MRRP, with ROIPool,
    ROILoopPool and ROIAlignV2: the pooler goes through its kernel once per
    channel chunk, detections are finite; train steps run the backward
    kernels. With both int8 keys the ROIPool and the ROILoopPool go through
    their maxabs emission (the ROILoopPool's 256-channel chunks: two), the
    align through its kernel, fc1 and the RPN conv through int8 GEMMs. A
    narrow Swin FPN detector through the level-routed pools."""
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
    _check_int8_models(cuda, cfg, batch, emb)
    _check_swin_fpn_model(cuda, batch, emb)

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
    _check_mrrp_vgg_train_step(cuda, batch, emb)

    # ROIAlignV2, plain and MRRP (routed by branch): one align launch per
    # chunk at inference; a plain train step with res5 trainable runs the
    # align's backward once
    cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
    for mrrp in (False, True):
        cfg.MODEL.MRRP.MRRP_ON = mrrp
        cfg.MODEL.ANCHOR_GENERATOR.SIZES = ([[32, 64], [128, 256], [512, 768]] if mrrp
                                            else [[32, 64, 128, 256, 512]])
        model = build_model(cfg, device=cuda, seed=0)
        before = align.LAUNCHES
        with torch.inference_mode():
            det, probs, boxes = model(batch, embeddings=emb)
        torch.cuda.synchronize()
        assert align.LAUNCHES == before + 1
        assert torch.isfinite(det.scores[det.valid]).all() and det.valid.any()
    cfg.MODEL.MRRP.MRRP_ON = False
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    model = build_model(cfg, device=cuda, seed=0).train()
    before = (align.LAUNCHES, align.BWD_LAUNCHES)
    losses = model.forward_train(batch, emb, iteration=5,
                                 generator=torch.Generator(device=cuda).manual_seed(0))
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    assert (align.LAUNCHES, align.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert len(losses) == 5 and all(torch.isfinite(v) for v in losses.values()), losses
    assert model.backbone.res5[0].conv1.weight.grad.abs().sum() > 0


def _check_swin_fpn_model(cuda, batch, emb):
    """A narrow Swin FPN detector (``wsovod_torch/config/swin_t_fpn.yaml``
    with embed 24, depths ``[2, 2, 1, 1]``, window 4, a 32-channel FPN) with
    ROIPool and ROILoopPool: one level-routed launch per batch (32 channels:
    one chunk), its ROIs on several levels, finite detections."""
    from wsovod_torch import get_cfg
    from wsovod_torch.models import build_model

    for pooler, attr in (("ROIPool", "LEVEL_LAUNCHES"), ("ROILoopPool", "LOOP_LEVEL_LAUNCHES")):
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(REPO, "wsovod_torch", "config", "swin_t_fpn.yaml"))
        cfg.TEST.AUG.ENABLED = False
        cfg.MODEL.SWIN.EMBED_DIM, cfg.MODEL.SWIN.DEPTHS = 24, [2, 2, 1, 1]
        cfg.MODEL.SWIN.NUM_HEADS, cfg.MODEL.SWIN.WINDOW_SIZE = [2, 2, 2, 2], 4
        cfg.MODEL.FPN.OUT_CHANNELS = 32
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
        cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE = pooler
        cfg.MODEL.ROI_BOX_HEAD.DAN_DIM = [64, 64]
        cfg.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_DIM = 16
        model = build_model(cfg, device=cuda, seed=0)
        levels = []
        hook = model.roi_heads.pooler.register_forward_hook(lambda m, i, o: levels.append(i[8]))
        before = getattr(port, attr)
        with torch.inference_mode():
            det, probs, boxes = model(batch, embeddings=emb)
        torch.cuda.synchronize()
        hook.remove()
        assert getattr(port, attr) == before + 1 and len(levels) == 1, pooler
        assert len(torch.unique(levels[0])) >= 2, pooler
        assert torch.isfinite(det.scores[det.valid]).all() and det.valid.any()


def _check_int8_models(cuda, cfg, batch, emb):
    """The narrow MRRP config of the caller and its plain form with both
    int8 keys, each pooler: the pool's launches, the int8 GEMMs (one per fc1
    chunk, nine per RPN level), finite detections."""
    from wsovod_torch.models import build_model
    from wsovod_torch.models import layers

    cfg = cfg.clone()
    cfg.TPU.DAN_FC1_QUANT = cfg.TPU.RPN_CONV_QUANT = "int8"
    for mrrp in (False, True):
        cfg.MODEL.MRRP.MRRP_ON = mrrp
        cfg.MODEL.ANCHOR_GENERATOR.SIZES = ([[32, 64], [128, 256], [512, 768]] if mrrp
                                            else [[32, 64, 128, 256, 512]])
        for pooler, mod, counter, chunks in (("ROIPool", port, "MAXABS_LAUNCHES", 1),
                                             ("ROILoopPool", port, "LOOP_MAXABS_LAUNCHES", 2),
                                             ("ROIAlignV2", align, "LAUNCHES", 1)):
            cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE = pooler
            model = build_model(cfg, device=cuda, seed=0)
            before, mms = getattr(mod, counter), layers.INT_MM_CALLS
            with torch.inference_mode():
                det, probs, boxes = model(batch, embeddings=emb)
            torch.cuda.synchronize()
            assert getattr(mod, counter) == before + chunks, (pooler, mrrp)
            assert layers.INT_MM_CALLS == mms + chunks + 9 * (3 if mrrp else 1), (pooler, mrrp)
            assert torch.isfinite(det.scores[det.valid]).all() and det.valid.any()


def _check_mrrp_vgg_train_step(cuda, batch, emb):
    """The MRRP VGG16 (``configs/COCO-Detection/WSOVOD_MRRP_V_16_DC5_1x.yaml``,
    narrow heads) at ``FREEZE_AT`` 4: inference pools once through the
    routed ROIPool; a train step pools once and runs the routed backward
    once, the losses are finite, plain1 and plain5 receive gradients and
    plain2-4 stay frozen."""
    from wsovod_torch import get_cfg
    from wsovod_torch.models import build_model

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "COCO-Detection",
                                     "WSOVOD_MRRP_V_16_DC5_1x.yaml"))
    cfg.MODEL.RPN.IN_FEATURES = ["plain5"]
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.ROI_BOX_HEAD.DAN_DIM = [64, 64]
    cfg.MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_DIM = 16
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64
    cfg.MODEL.BACKBONE.FREEZE_AT = 4
    cfg.TEST.AUG.ENABLED = False
    model = build_model(cfg, device=cuda, seed=0)
    before = port.LAUNCHES
    with torch.inference_mode():
        det, _, _ = model(batch, embeddings=emb)
    torch.cuda.synchronize()
    assert port.LAUNCHES == before + 1
    assert torch.isfinite(det.scores[det.valid]).all() and det.valid.any()
    model.train()
    before = (port.LAUNCHES, port.BWD_LAUNCHES)
    losses = model.forward_train(batch, emb, iteration=5,
                                 generator=torch.Generator(device=cuda).manual_seed(0))
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    assert (port.LAUNCHES, port.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert len(losses) == 5 and all(torch.isfinite(v) for v in losses.values()), losses
    bb = model.backbone
    assert bb.plain1.conv1.weight.grad.abs().sum() > 0 and bb.plain5.conv3.weight.grad.abs().sum() > 0
    assert bb.plain2.conv1.weight.grad is None and not bb.plain4.conv3.weight.requires_grad
