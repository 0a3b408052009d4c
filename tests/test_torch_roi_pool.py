"""The port's plain gated ROIPool against the JAX reference
``wsovod_tpu.ops.roi_pool.roi_pool`` times the gate: exact (atol 0) in
float32 and bfloat16, with overhanging, degenerate, .5-boundary and invalid
boxes and a nonzero channel base; the wrapper contracts of both pool
kernels, the gated ROIPool's with and without a per-ROI source copy (the
ROILoopPool's numbers are in ``test_torch_mrrp.py``, the routed ROIPool's
against the JAX package in ``test_torch_mrrp.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsovod_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from wsovod_torch.ops import roi_pool as port

SCALE = 0.125  # stride 8, the DC5 res5 scale
P = 7


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
