"""The port's plain gated ROIPool against the JAX reference
``wsovod_tpu.ops.roi_pool.roi_pool`` times the gate: exact (atol 0) in
float32 and bfloat16, with overhanging, degenerate, .5-boundary and invalid
boxes and a nonzero channel base; the wrapper contracts of the pool and
align kernels, the gated ROIPool's with and without a per-ROI source copy
(the ROILoopPool's numbers are in ``test_torch_mrrp.py``, the routed
ROIPool's against the JAX package in ``test_torch_mrrp.py``).

The gated ROIAlign (``wsovod_torch.ops.roi_align``), inside the same items:

* against ``wsovod_tpu.ops.roi_pool.roi_align`` times the gate, for
  ``sampling_ratio`` 1 and 2, unrouted and routed by a per-ROI source copy,
  with overhanging, degenerate, zero-area, wholly outside, invalid and
  gate-0 rows. float32: atol 1e-5 of ``max |feat|`` (float32 summation
  order). bfloat16: the port sums in float32 and rounds once, so it lies
  within one bfloat16 step (plus the float32 atol) of the reference's
  float32 result on the bfloat16-rounded features (the jnp gather path in
  bfloat16 rounds at every step, and is not the yardstick). ``ROIAlign`` (``aligned`` false) against
  ``roi_align(aligned=False)``, float32.
* The windowed mode against ``roi_align_pallas`` in interpret mode, times
  the gate, at ``sampling_ratio`` 2 (the pooler's), with ROIs longer than
  their window, where exact and windowed differ: float32, atol 1e-5 of
  ``max |feat|``.
* The plain backward against the JAX package's ``_fused_ad_bwd`` (both
  cotangents), float32, rtol and atol 1e-5; routed by branch, each copy's
  cotangent equals the unrouted backward of the ROIs that read it (rtol
  1e-6: float32 summation order).

The level-routed ROIPool (kernel 2.5, ``roi_pool_levels``: each ROI pooled
on its own FPN level), inside the same items: against the JAX package's
multi-level ``ROIPooler`` on the jnp path times the gate (unclipped,
overhanging, degenerate, wholly outside and invalid boxes, a small canonical
box so the ROIs fall on all four levels, float32 and bfloat16), and against
``roi_pool_pallas`` in interpret mode per level (boxes clipped to the image,
ROADMAP 3.1; one ROI per grid step, 3x3 bins, float32): exact.

The emission modes of the gated ROIPool (``maxabs``, ``int8``, ``tile8``)
and of the align (``int8``), inside the same items:

* against the TPU kernels (``roi_pool_fused_batched(..., quant=...)``,
  ``roi_align_fused_batched(..., quant="int8", hwnc_out=True)``) in Pallas
  interpret mode, on boxes clipped to the image (ROADMAP 3.1), the same
  ``c_tile`` on both sides, 3x3 bins (the kernels' interpret trace grows
  with the bins): the ROIPool's payloads and scales exactly; the
  align's raw float32 sums differ from the TPU kernel's by float32
  summation order, so its payload is exact but where a sum lies within
  that rounding of a .5 tie, one int8 step (such ties are counted: at most
  1 in 2000 entries), its scales rtol 1e-5 (float32 summation order, as
  the align's float checks above);
* against the jnp reference pool (``roi_pool``, ``roi_align``) and the
  quantize formula in numpy, 7x7 bins, with overhanging, degenerate,
  invalid and gate-0 boxes and a channel chunk at 8: exact for the ROIPool (float32
  and bfloat16; the maxabs payload is ``roi_pool_gated``'s bit for bit),
  the align as against the TPU kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (
    LEVEL_SCALES, clip_to_image, jax_level_pool, jax_pallas_per_level, jax_pool_emission,
    level_pool_inputs, np_quant_scale, np_quantize_tiles, port_levels, routed_pool_inputs,
)
from wsovod_tpu.ops.pallas.roi_align_fused import _fused_ad_bwd, roi_align_fused_batched
from wsovod_tpu.ops.pallas.roi_align_kernel import roi_align_pallas
from wsovod_tpu.ops.roi_pool import roi_align as jax_roi_align
from wsovod_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from wsovod_torch.ops import roi_align as align
from wsovod_torch.ops import roi_pool as port

SCALE = 0.125  # stride 8, the DC5 res5 scale
P = 7
PJ = 3  # bins per axis against the TPU kernels in interpret mode (their trace grows with them)


def _inputs(seed, b=2, h=9, w=13, c=24, n=40):
    rng = np.random.RandomState(seed)
    feat = rng.randn(b, h, w, c).astype(np.float32)  # any sign: no post-ReLU assumption
    img_w, img_h = w / SCALE, h / SCALE
    xy = rng.uniform(-20, img_w * 0.8, (b, n, 2))
    wh = rng.uniform(1, img_w * 0.7, (b, n, 2))
    rois = np.concatenate([xy, xy + wh], -1)
    # overhanging the right/bottom and the top/left edges
    rois[:, 0] = [img_w - 10, img_h - 30, img_w + 40, img_h + 50]
    rois[:, 1] = [-35, -12, 30, 20]
    # degenerate: x2 < x1, y2 < y1, zero-size
    rois[:, 2] = [50, 40, 20, 10]
    rois[:, 3] = [33, 33, 33, 33]
    # exact .5 boundaries at scale 1/8: 100 * 0.125 = 12.5, 4 -> 0.5, 12 -> 1.5
    rois[:, 4] = [4, 12, 100, 60]
    rois[:, 5] = [12, 4, 60, 100]
    # whole image and beyond
    rois[:, 6] = [-100, -100, img_w + 100, img_h + 100]
    gate = rng.uniform(0.5, 2.0, (b, n)).astype(np.float32)
    valid = rng.rand(b, n) > 0.2
    valid[:, :7] = True
    valid[:, 7] = False
    gate = gate * valid
    rois = np.where(valid[..., None], rois, 0.0).astype(np.float32)
    return feat, rois, gate


def _reference(feat, rois, gate, c_base, c_take, dtype):
    out = []
    for i in range(feat.shape[0]):
        f = jnp.asarray(feat[i], dtype)
        pooled = jax_roi_pool(f, jnp.asarray(rois[i]), P, SCALE)[..., c_base:c_base + c_take]
        out.append(pooled * jnp.asarray(gate[i]).astype(dtype)[:, None, None, None])
    return np.asarray(jnp.stack(out).astype(jnp.float32))


def test_plain_gated_pool_exact():
    """Every dtype and channel chunk, exact; a tiny temporary budget (one
    ROI per chunk) gives the same bits; .5 boundaries round as the
    reference."""
    feat, rois, gate = _inputs(0)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for c_base, c_take in ((0, 24), (8, 10)):
            want = _reference(feat, rois, gate, c_base, c_take, jnp.dtype(dtype))
            got = port.roi_pool_gated(
                torch.from_numpy(feat).to(tdt), torch.from_numpy(rois), torch.from_numpy(gate),
                c_base, c_take, P, SCALE,
            )
            assert got.dtype == tdt and got.shape == (2, rois.shape[1], P, P, c_take)
            np.testing.assert_array_equal(got.float().numpy(), want, err_msg=f"{dtype} {c_base}+{c_take}")

    feat, rois, gate = _inputs(1, n=9)
    args = (torch.from_numpy(feat), torch.from_numpy(rois), torch.from_numpy(gate), 0, 24, P, SCALE)
    assert torch.equal(port.roi_pool_gated_plain(*args), port.roi_pool_gated_plain(*args, max_elems=1))

    reg = port.round_region(torch.tensor([[[4.0, 12.0, 100.0, 60.0], [-4.0, 3.9, 3.99, 4.01]]]), SCALE)
    # floor(x/8 + .5): 4 -> 1, 12 -> 2, 100 -> 13, 60 -> 8; w = 13-1+1, h = 8-2+1
    assert reg[0, 0].tolist() == [1, 2, 13, 7]
    # -4 -> 0, 3.9 -> 0, 3.99 -> 0, 4.01 -> 1; degenerate sizes clamp to >= 1
    assert reg[0, 1].tolist() == [0, 0, 1, 2]
    _check_align()
    _check_align_window()
    _check_align_backward()
    _check_emissions()
    _check_align_int8()
    _check_level_pool()


def _check_level_pool():
    """The level-routed ROIPool's plain version (the CPU path of
    ``roi_pool_levels``) against the JAX multi-level pooler and, per level,
    ``roi_pool_pallas`` (see the module docstring); a tiny temporary budget
    gives the same bits; it pools each ROI on its level only."""
    feats, rois, gate, valid = level_pool_inputs(0)
    level = port_levels(rois)
    assert len(torch.unique(level)) == len(LEVEL_SCALES)
    wants = jax_level_pool(feats, rois, gate, valid, "ROIPool", (jnp.float32, jnp.bfloat16))
    for dtype, want in zip(("float32", "bfloat16"), wants):
        tdt = getattr(torch, dtype)
        for c_base, c_take in ((0, 8), (2, 4)):
            got = port.roi_pool_levels([_t(f).to(tdt) for f in feats], _t(rois), _t(gate), level,
                                       c_base, c_take, P, LEVEL_SCALES)
            assert got.dtype == tdt and got.shape == (2, rois.shape[1], P, P, c_take)
            np.testing.assert_array_equal(got.float().numpy(), want[..., c_base:c_base + c_take],
                                          err_msg=f"{dtype} {c_base}+{c_take}")
    assert (np.abs(want[:, :7]).reshape(2, 7, -1).max(-1) > 0).any() and not want[:, 7].any()
    args = ([_t(f) for f in feats], _t(rois), _t(gate), level, 0, 8, P, LEVEL_SCALES)
    assert torch.equal(port.roi_pool_levels_plain(*args),
                       port.roi_pool_levels_plain(*args, max_elems=1))
    # one level's map changed: only the ROIs on that level change
    moved = [f.copy() for f in feats]
    moved[2] = moved[2] + 5.0
    other = port.roi_pool_levels([_t(f) for f in moved], *args[1:])
    on2 = (level == 2).numpy() & valid
    diff = (other - port.roi_pool_levels(*args)).abs().flatten(2).amax(-1).numpy()
    assert (diff[on2] > 0).all() and not diff[~on2].any()

    img_w, img_h = 136.0, 100.0
    rois_c = clip_to_image(rois, img_w, img_h)
    level_c = port_levels(rois_c)
    want = jax_pallas_per_level(feats, rois_c, gate, level_c.numpy(), loop=False, p=PJ)
    got = port.roi_pool_levels([_t(f) for f in feats], _t(rois_c), _t(gate), level_c, 0, 8, PJ,
                               LEVEL_SCALES)
    np.testing.assert_array_equal(got.numpy(), want)


def _t(x):
    return torch.from_numpy(np.array(x))


def _align_inputs(seed, n=24):
    """``_inputs`` plus a zero-area row, a wholly outside row and a valid
    row of gate 0."""
    feat, rois, gate = _inputs(seed, n=n)
    img_w, img_h = feat.shape[2] / SCALE, feat.shape[1] / SCALE
    rois[:, 8] = [40, 30, 40, 30]  # zero area
    rois[:, 9] = [img_w + 20, img_h + 20, img_w + 90, img_h + 60]  # wholly outside
    rois[:, 10] = [10, 10, 60, 50]
    gate[:, 8:11] = [[1.5, 1.2, 0.0]]
    return feat, rois, gate


def _jax_align(feat, rois, gate, c_base, c_take, s, aligned=True, src=None):
    """``roi_align(feat[copy], rois[b]) * gate`` per ROI, float32 numpy
    ``[B, N, 7, 7, c_take]``; ``src`` picks each ROI's copy."""
    b, n = gate.shape
    f = np.ascontiguousarray(feat[..., c_base:c_base + c_take], np.float32)
    out = np.zeros((b, n, P, P, c_take), np.float32)
    for i in range(b):
        copies = [i] if src is None else np.unique(src[i])
        for cp in copies:
            pooled = np.asarray(jax_roi_align(f[cp], rois[i], P, SCALE, sampling_ratio=s,
                                              aligned=aligned))
            sel = slice(None) if src is None else src[i] == cp
            out[i, sel] = (pooled * gate[i][:, None, None, None])[sel]
    return out


def _bf16_step(x):
    """One bfloat16 step at |x| (8 significant bits)."""
    a = np.abs(x)
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7), 1e-30)


def _check_align():
    """The plain gated ROIAlign against the JAX package's ``roi_align``
    times the gate (see the module docstring)."""
    feat, rois, gate = _align_inputs(3)
    atol = 1e-5 * np.abs(feat).max()
    three = np.concatenate([feat, -feat, 2 * feat])  # [6, H, W, C]: three copies per image
    src = (np.arange(2)[:, None] + 2 * (np.arange(rois.shape[1]) % 3)[None]).astype(np.int32)
    for s in (1, 2):
        for name, f, sr in (("unrouted", feat, None), ("routed", three, src)):
            want = _jax_align(f, rois, gate, 8, 10, s, src=sr)
            got = align.roi_align_gated(_t(f), _t(rois), _t(gate), 8, 10, P, SCALE, s,
                                        src=None if sr is None else _t(sr))
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol, err_msg=f"{name} s={s}")
            # bfloat16: one bfloat16 step of the float32 result on the rounded features
            fb = torch.from_numpy(f).bfloat16()
            want_b = _jax_align(fb.float().numpy(), rois, gate, 8, 10, s, src=sr)
            got_b = align.roi_align_gated(fb, _t(rois), _t(gate), 8, 10, P, SCALE, s,
                                          src=None if sr is None else _t(sr))
            assert got_b.dtype == torch.bfloat16
            err = np.abs(got_b.float().numpy() - want_b)
            assert (err <= _bf16_step(want_b) + atol).all(), (name, s, err.max())
        # the edge rows pool something; the invalid, wholly outside and gate-0 rows nothing
        assert (np.abs(want[:, [0, 1, 2, 3, 4, 5, 6, 8]]).reshape(2, 8, -1).max(-1) > 0).all()
        assert not want[:, 9:11].any() and not want[:, 7].any()
    # ROIAlign (V1): offset 0, sizes floored at 1
    want = _jax_align(feat, rois, gate, 8, 10, 2, aligned=False)
    got = align.roi_align_gated(_t(feat), _t(rois), _t(gate), 8, 10, P, SCALE, 2, aligned=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    v2 = align.roi_align_gated(_t(feat), _t(rois), _t(gate), 8, 10, P, SCALE, 2)
    assert (got - v2).abs().max() > 1e-3  # V1 differs


def _check_align_window():
    """The windowed mode against ``roi_align_pallas`` in interpret mode,
    times the gate: a 40x48 map at scale 1/4, window 16 (``win_y = win_x =
    24``), ROIs inside and longer than their window, at the map's edges and
    overhanging; the long ROIs pool differently from the exact align."""
    rng = np.random.RandomState(7)
    h, w, c, scale, win = 40, 48, 8, 0.25, 16
    feat = rng.randn(1, h, w, c).astype(np.float32)
    rois = np.array([[[8, 12, 40, 36],  # inside its window
                      [10, 6, 150, 120],  # longer than its window on both axes
                      [30, 20, 60, 170],  # longer on y
                      [100, 100, 190, 158],  # reaches the right and bottom edges
                      [-20, -16, 30, 40],  # overhangs left and top
                      [0, 0, 192, 160],  # the whole map
                      # degenerate, less than a pixel backwards: roi_align_pallas skips
                      # (and leaves unwritten) a ROI whose extent is -1 or less
                      [60, 60, 57, 58],
                      [20, 24, 20, 24]]], np.float32)  # zero area
    gate = rng.uniform(0.5, 2.0, (1, rois.shape[1])).astype(np.float32)
    want = np.asarray(roi_align_pallas(jnp.asarray(feat[0]), jnp.asarray(rois[0]), P, scale,
                                       sampling_ratio=2, win=win, c_tile=c, roi_block=1,
                                       interpret=True)) * gate[0][:, None, None, None]
    got = align.roi_align_gated(_t(feat), _t(rois), _t(gate), 0, c, P, scale, 2, window=win)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-5 * np.abs(feat).max())
    exact = align.roi_align_gated(_t(feat), _t(rois), _t(gate), 0, c, P, scale, 2)
    differs = np.abs(exact[0].numpy() - want).reshape(len(want), -1).max(-1) > 1e-3
    assert differs[1] and differs[2] and not differs[0], differs


def _check_align_backward():
    """The plain backward against ``_fused_ad_bwd``; routed by branch, per
    copy against the unrouted backward."""
    feat, rois, gate = _align_inputs(4)
    c_base, c_take, s = 4, 8, 2
    out = _jax_align(feat, rois, gate, c_base, c_take, s)
    g = np.random.RandomState(5).randn(*out.shape).astype(np.float32)
    res = tuple(jnp.asarray(a) for a in (feat, rois, gate, out))
    want_feat, _, want_gate = jax.jit(
        lambda res, g: _fused_ad_bwd(c_base, c_take, P, SCALE, s, False, res, g))(res, jnp.asarray(g))
    got_feat, got_gate = align.roi_align_gated_bwd_plain(_t(feat), _t(rois), _t(gate), _t(out),
                                                         _t(g), c_base, c_take, P, SCALE, s)
    np.testing.assert_allclose(got_feat.numpy(), want_feat, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_gate.numpy(), want_gate, rtol=1e-5, atol=1e-5)
    assert np.abs(want_feat).max() > 0 and (got_gate.numpy()[:, 10] == 0).all()
    assert not got_feat[..., :c_base].any() and not got_feat[..., c_base + c_take:].any()
    assert align.roi_align_gated_bwd_plain(_t(feat), _t(rois), _t(gate), None, _t(g), c_base,
                                           c_take, P, SCALE, s, need_gate=False)[1] is None

    # routed by branch: each copy's cotangent is the unrouted backward of the
    # ROIs that read it (checked against the JAX package above), on its own
    feat, rois, gate, src = routed_pool_inputs(3)
    b = gate.shape[0]
    g = np.random.RandomState(6).randn(b, gate.shape[1], P, P, c_take).astype(np.float32)
    got_feat, _ = align.roi_align_gated_bwd_plain(_t(feat), _t(rois), _t(gate), None, _t(g),
                                                  c_base, c_take, P, SCALE, s, need_gate=False,
                                                  src=_t(src))
    for k in range(feat.shape[0]):
        reads = src == k  # [B, N]: the ROIs of image k % b that read copy k
        i = k % b
        want_k, _ = align.roi_align_gated_bwd_plain(
            _t(feat[k:k + 1]), _t(rois[i:i + 1]),
            _t(gate[i:i + 1] * reads[i:i + 1]), None, _t(g[i:i + 1]), c_base, c_take, P, SCALE, s,
            need_gate=False)
        assert reads.any() and np.abs(want_k.numpy()).max() > 0
        np.testing.assert_allclose(got_feat[k].numpy(), want_k[0].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=f"copy {k}")


def test_wrapper_contract():
    """The CPU path counts no kernel launch; malformed inputs raise; the
    routed pool equals the unrouted one on each ROI's copy."""
    feat, rois, gate = (torch.from_numpy(a) for a in _inputs(2, n=9))
    before = port.LAUNCHES
    port.roi_pool_gated(feat, rois, gate, 0, 24)
    assert port.LAUNCHES == before

    bad_inputs = {
        "feat_rank": (feat[0], rois, gate, 0),
        "rois_shape": (feat, rois[..., :3], gate, 0),
        "gate_shape": (feat, rois, gate[:, :2], 0),
        "chunk": (feat, rois, gate, 16),
        "device": (feat.to("meta"), rois.to("meta"), gate.to("meta"), 0),
    }
    for name, (f, r, g, c_base) in bad_inputs.items():
        with pytest.raises(ValueError):
            port.roi_pool_gated(f, r, g, c_base, 24)
            pytest.fail(f"{name} was accepted")

    # routed by a per-ROI source copy: src = the image gives the unrouted
    # pool; a tiny temporary budget gives the same bits; a feature of other
    # copies than images needs src; a bad src raises
    src = torch.zeros(gate.shape, dtype=torch.int32) + torch.arange(2, dtype=torch.int32)[:, None]
    assert torch.equal(port.roi_pool_gated(feat, rois, gate, 0, 24, P, SCALE, src),
                       port.roi_pool_gated(feat, rois, gate, 0, 24, P, SCALE))
    three = torch.cat([feat, -feat, feat * 2])  # [6, H, W, C]: three copies per image
    routed = src + 2 * torch.tensor([[0, 1, 2, 0, 1, 2, 0, 1, 2]], dtype=torch.int32)
    got = port.roi_pool_gated(three, rois, gate, 0, 24, P, SCALE, routed)
    assert port.LAUNCHES == before
    assert torch.equal(got, port.roi_pool_gated_plain(three, rois, gate, 0, 24, P, SCALE,
                                                      max_elems=1, src=routed))
    for k in range(9):
        one = port.roi_pool_gated(three[routed[:, k]].contiguous(), rois[:, k:k + 1],
                                  gate[:, k:k + 1], 0, 24, P, SCALE)
        assert torch.equal(got[:, k:k + 1], one), k
    for bad in ((three, None), (three, routed[:, :2]), (three, routed + 5), (three, routed - 3)):
        with pytest.raises(ValueError):
            port.roi_pool_gated(bad[0], rois, gate, 0, 24, P, SCALE, bad[1])
    with pytest.raises(TypeError):
        port.roi_pool_gated(three, rois, gate, 0, 24, P, SCALE, routed.float())

    # the loop pool's wrapper: the same contract; a tiny temporary budget
    # (one ROI per chunk) gives the same bits
    before = port.LOOP_LAUNCHES
    out = port.roi_loop_pool_gated(feat, rois, gate, src, 0, 24, 3, P, SCALE)
    assert port.LOOP_LAUNCHES == before
    assert torch.equal(out, port.roi_loop_pool_gated_plain(feat, rois, gate, src, 0, 24, 3, P, SCALE,
                                                           max_elems=1))
    bad_loop = {
        "rows": ((feat, rois, gate, src, 0, 24), {"rows": 4}),
        "src_shape": ((feat, rois, gate, src[:, :2], 0, 24), {}),
        "src_range": ((feat, rois, gate, src + 1, 0, 24), {}),
        "src_negative": ((feat, rois, gate, src - 1, 0, 24), {}),
        "chunk": ((feat, rois, gate, src, 16, 24), {}),
        "device": ((feat.to("meta"), rois.to("meta"), gate.to("meta"), src.to("meta"), 0, 24), {}),
    }
    for name, (args, kw) in bad_loop.items():
        with pytest.raises(ValueError):
            port.roi_loop_pool_gated(*args, **kw)
            pytest.fail(f"loop {name} was accepted")
    with pytest.raises(TypeError):
        port.roi_loop_pool_gated(feat, rois, gate, src.float(), 0, 24)

    # the align's wrapper: the same contract; a tiny temporary budget (one ROI
    # per group) gives the same bits; the windowed mode has no feature backward
    before = (align.LAUNCHES, align.BWD_LAUNCHES)
    out = align.roi_align_gated(feat, rois, gate, 0, 24, P, SCALE, 2, src=src)
    assert torch.equal(out, align.roi_align_gated_plain(feat, rois, gate, 0, 24, P, SCALE, 2,
                                                        src=src, max_elems=1))
    align.roi_align_gated_bwd(feat, rois, gate, out, torch.ones_like(out), 0, 24, P, SCALE, 2)
    assert (align.LAUNCHES, align.BWD_LAUNCHES) == before
    for name, (f, r, g, c_base) in bad_inputs.items():
        with pytest.raises(ValueError):
            align.roi_align_gated(f, r, g, c_base, 24)
            pytest.fail(f"align {name} was accepted")
    with pytest.raises(ValueError):
        align.roi_align_gated(three, rois, gate, 0, 24, P, SCALE, 2, src=routed + 5)
    with pytest.raises(ValueError):
        align.roi_align_gated_bwd(feat, rois, gate, None, out[:, :2], 0, 24, P, SCALE, 2)
    leaf = feat.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError):
        align.RoIAlignGatedFunction.apply(leaf, rois, gate, 0, 24, P, SCALE, 2, True, None, 32)

    # the level-routed pools' wrappers: no launch counted on the CPU; a bad
    # level, chunk, level count or shape raises; no backward
    feats, lrois, lgate, _ = (level_pool_inputs(1))
    feats = [_t(f) for f in feats]
    lrois, lgate = _t(lrois), _t(lgate)
    level = port_levels(lrois.numpy())
    before = (port.LEVEL_LAUNCHES, port.LOOP_LEVEL_LAUNCHES)
    port.roi_pool_levels(feats, lrois, lgate, level, 0, 8, P, LEVEL_SCALES)
    port.roi_loop_pool_levels(feats, lrois, lgate, level, 0, 8, 1, P, LEVEL_SCALES)
    assert (port.LEVEL_LAUNCHES, port.LOOP_LEVEL_LAUNCHES) == before
    bad_levels = {
        "level_range": (feats, level + 1, 0, 8, LEVEL_SCALES),
        "level_negative": (feats, level - 1, 0, 8, LEVEL_SCALES),
        "level_shape": (feats, level[:, :3], 0, 8, LEVEL_SCALES),
        "scales": (feats, level, 0, 8, LEVEL_SCALES[:3]),
        "chunk": (feats, level, 4, 8, LEVEL_SCALES),
        "batch": ([f[:1] for f in feats], level, 0, 8, LEVEL_SCALES),
    }
    for name, (f, lv, c_base, c_take, sc) in bad_levels.items():
        for fn in (port.roi_pool_levels, port.roi_loop_pool_levels):
            with pytest.raises(ValueError):
                fn(f, lrois, lgate, lv, c_base, c_take, output_size=P, scales=sc)
                pytest.fail(f"{fn.__name__} {name} was accepted")
    with pytest.raises(TypeError):
        port.roi_pool_levels(feats, lrois, lgate, level.float(), 0, 8, P, LEVEL_SCALES)
    with pytest.raises(NotImplementedError):
        port.roi_pool_levels([f.clone().requires_grad_(True) for f in feats], lrois, lgate, level,
                             0, 8, P, LEVEL_SCALES)


def _check_emissions():
    """The ROIPool's maxabs, int8 and tile8 emissions against the TPU
    kernel in interpret mode (clipped boxes, 256 channels in two 128-channel
    tiles), then against the jnp reference and the formula on the edge
    boxes of ``_inputs``."""
    feat, rois, gate = _inputs(5, c=256, n=24)
    img_w, img_h = feat.shape[2] / SCALE, feat.shape[1] / SCALE
    rois_c = clip_to_image(rois, img_w, img_h)
    f, r, g = _t(feat), _t(rois_c), _t(gate)
    # maxabs: the gated payload and max |payload| per (ROI, chunk)
    want, part = jax_pool_emission(feat, rois_c, gate, "maxabs", 128)
    got, m = port.roi_pool_gated_maxabs(f, r, g, 0, 256, PJ, SCALE)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(m.numpy(), part.max(axis=(1, 3)))  # partials [B, n_ct, N, lanes]
    # int8: payload and per-(ROI, c_tile) scales [B, n_ct, N]
    want_q, want_s = jax_pool_emission(feat, rois_c, gate, "int8", 128)
    got_q, got_s = port.roi_pool_gated_int8(f, r, g, 0, 256, 128, PJ, SCALE)
    assert got_q.dtype == torch.int8 and got_s.shape == (2, 2, 24) and got_q.shape[2] == PJ
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # tile8: the per-image quantized chunk's max pool, scale gate * s
    want_q, want_s = jax_pool_emission(feat, rois_c, gate, "tile8", 128)
    got_q, got_s = port.roi_pool_gated_tile8(f, r, g, 0, 256, PJ, SCALE)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s[:, 0])  # every tile holds gate * s
    assert np.abs(want_q).max() == 127 and (got_s.numpy()[gate == 0] == 0).all()

    # against the jnp reference and the formula, edge boxes included
    c_base, c_take, c_tile = 8, 16, 8
    ones = np.ones_like(gate)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        ft = _t(feat).to(tdt)
        pooled = _reference(feat, rois, gate, c_base, c_take, jnp.dtype(dtype))
        out, m = port.roi_pool_gated_maxabs(ft, _t(rois), _t(gate), c_base, c_take, P, SCALE)
        assert torch.equal(out, port.roi_pool_gated(ft, _t(rois), _t(gate), c_base, c_take, P,
                                                    SCALE))
        np.testing.assert_array_equal(out.float().numpy(), pooled)
        np.testing.assert_array_equal(m.numpy(), np.abs(pooled).max(axis=(2, 3, 4)))
        v = _reference(feat, rois, ones, c_base, c_take, jnp.dtype(dtype))  # pre-gate
        q, mt = np_quantize_tiles(v, c_tile)
        got_q, got_s = port.roi_pool_gated_int8(ft, _t(rois), _t(gate), c_base, c_take, c_tile, P,
                                                SCALE)
        np.testing.assert_array_equal(got_q.numpy(), q, err_msg=dtype)
        np.testing.assert_array_equal(got_s.numpy(), np_quant_scale(gate[..., None], mt)
                                      .transpose(0, 2, 1))
    # tile8: the reference pool of the chunk quantized per image
    f32 = feat[..., c_base:c_base + c_take]
    s = np.maximum(np.abs(f32).max(axis=(1, 2, 3)) * np.float32(1 / 127.0), np.float32(1e-20))
    fq = np.clip(np.round(f32 / s[:, None, None, None]), -127, 127).astype(np.float32)
    want = _reference(fq, rois, ones, 0, c_take, jnp.float32)
    got_q, got_s = port.roi_pool_gated_tile8(_t(feat), _t(rois), _t(gate), c_base, c_take, P,
                                             SCALE)
    np.testing.assert_array_equal(got_q.numpy(), want.astype(np.int8))
    np.testing.assert_array_equal(got_s.numpy(), gate * s[:, None])
    with pytest.raises(ValueError):
        port.roi_pool_gated_int8(f, r, g, 0, 256, 96, P, SCALE)  # c_tile must divide c_take


def _count_steps(got, want, what, frac=5e-4):
    """int8 payloads equal except for entries one step apart (rounding ties
    of float32 sums taken in another order), at most ``frac`` of them."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= frac, (what, d.max(), int((d > 0).sum()))


def _check_align_int8():
    """The align's int8 emission against ``roi_align_fused_batched(...,
    quant="int8")`` in interpret mode (clipped boxes) and against the jnp
    ``roi_align`` with the formula (edge boxes); the plain version is the
    kernel's stand-in."""
    feat, rois, gate = _align_inputs(6)
    feat = np.concatenate([feat] * 11, -1)[..., :256]  # 256 channels: two 128-channel tiles
    img_w, img_h = feat.shape[2] / SCALE, feat.shape[1] / SCALE
    rois_c = clip_to_image(rois, img_w, img_h)
    q, sc = jax.jit(lambda f, r, g: roi_align_fused_batched(
        f, r, g, 0, PJ, SCALE, 2, c_take=256, c_tile=128, roi_block=1, interpret=True,
        hwnc_out=True, quant="int8"))(jnp.asarray(feat), jnp.asarray(rois_c), jnp.asarray(gate))
    got_q, got_s = align.roi_align_gated_int8(_t(feat), _t(rois_c), _t(gate), 0, 256, 128, PJ,
                                              SCALE, 2)
    _count_steps(got_q.numpy(), np.asarray(q).transpose(0, 3, 1, 2, 4), "vs the TPU kernel")
    np.testing.assert_allclose(got_s.numpy(), np.asarray(sc), rtol=1e-5, atol=0)
    # the jnp reference: its raw sums are 4x (s * s) its normalised output, exactly
    c_base, c_take, c_tile = 8, 16, 8
    raw = _jax_align(feat, rois, np.ones_like(gate), c_base, c_take, 2) * np.float32(4)
    q, m = np_quantize_tiles(raw, c_tile)
    got_q, got_s = align.roi_align_gated_int8(_t(feat), _t(rois), _t(gate), c_base, c_take,
                                              c_tile, P, SCALE, 2)
    _count_steps(got_q.numpy(), q, "vs the jnp reference")
    want_s = np_quant_scale((gate * np.float32(0.25))[..., None], m).transpose(0, 2, 1)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=0)
    # the payload is gate-free: the invalid and gate-0 rows have scale 0
    assert (got_s[:, :, [7, 10]] == 0).all() and (got_s[:, :, :7] > 0).all()
