#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``wsovod_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the last line is printed:

1. Device and build: the card's name and power limit (``nvidia-smi``), TF32
   off for matmuls and convolutions, the eight CUDA kernels built from
   ``wsovod_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a`` (one ``nvcc``
   per source, started together).
2. The gated ROIPool kernel against its plain PyTorch version at the plain
   slice's shapes (res5 ``[2, 86, 132, 2048]``, 5024 ROIs per image from the
   ``bench.py`` box mix plus overhanging, degenerate and invalid rows),
   bfloat16 and float32: bit-for-bit equality, and both times.
3. The gated, branch-routed ROILoopPool kernel against its plain version at
   the MRRP slice's shapes (three branch copies, ``[6, 86, 132, 2048]``, the
   same ROIs, each on a branch drawn from a seed): rows 1 and 3, bfloat16
   and float32, one or two chunks at full N and every chunk at a reduced N,
   bit-for-bit; ``rows=1`` equals row 0 of ``rows=3``; both times. Then the
   gated ROIPool routed by branch (a per-ROI source copy) against its plain
   version at the MRRP VGG16 slice's shapes (plain5's three copies ``[6,
   85, 131, 512]``, 5024 ROIs per image on seeded branches), bfloat16 and
   float32, bit for bit; both times. Then the gated ROIAlign kernel against
   its plain version at the ``align`` slice's shapes (``[2, 86, 132,
   2048]``) and, routed by branch, at the ``mrrp-align`` slice's (``[6, 86,
   132, 2048]``): the same box mix plus zero-area and gate-0 rows, 2 samples
   per bin axis, bfloat16 and float32, exact and windowed (``pallas_approx``),
   one chunk at full N and every chunk at a reduced N, to float tolerance
   (float32 sums in another order); all times. Then the pool kernels'
   emission modes against their plain versions, bit for bit (payloads and
   scales), bfloat16 (float32 at a reduced N), each timed with its plain
   version and bound: the ROIPool's maxabs (its payload also equal to the gated pool's),
   int8 (``c_tile`` 256 of a 512-channel chunk) and tile8 at the plain
   slice's shapes; the ROILoopPool's maxabs (rows 1 at full N on the int8
   slice's 256-channel chunk, rows 3 at a reduced N) and int8 at the MRRP
   slice's; the align's int8 at the ``align`` slice's shapes (and routed,
   windowed, at a reduced N). Then the int8 fc1's GEMM (``torch._int_mm``)
   on one chunk and the int8 RPN conv, each against its bf16 counterpart.
   Then the level-routed ROIPool and ROILoopPool (kernel 2.5) against their
   plain versions at the ``swin-fpn`` slices' level shapes (p2 ``[2, 172,
   264, 256]`` to p5 ``[2, 22, 33, 256]``), 5024 ROIs per image from the
   same box mix with the edge rows, each on its level by d2's rule (every
   level gets some): bfloat16 and float32, the loop rows 1 and 3, bit for
   bit; times and bounds. Then kernel 2.9, the TPU microbenchmarks' walks
   of one map resident in the L2 (``wsovod_torch/scripts``): the row fold
   (``row_fold.cu``) in float32, bfloat16 and int8 and the bin row walk
   (``row_walk.cu``) in cases A-F at the JAX scripts' shapes (``[86, 136,
   512]``), each result held bit for bit against its plain version, timed
   with the scripts' lines (ms, Gelem/s or ns per row, the walk's GB/s, the
   bound); each at a quarter of its pseudo-ROIs or ROIs takes at most 0.4
   of its time at the full count, so the whole walk runs. Neither is on a
   model path: their launch counts stay 0 in every slice.
4. The plain slice: ``build_model`` on ``configs/COCO-Detection/
   WSOVOD_WSR_50_DC5_1x.yaml``; 5. the MRRP slice, the same on
   ``WSOVOD_MRRP_WSR_50_DC5_1x.yaml`` (three branches at test); then the
   ``vgg`` and ``mrrp-vgg`` slices on ``WSOVOD_V_16_DC5_1x.yaml`` and
   ``WSOVOD_MRRP_V_16_DC5_1x.yaml`` (``RPN.IN_FEATURES`` set to
   ``["plain5"]``, which the YAMLs leave at the base's ``res5``; plain5 is
   one 512-channel chunk, ``[B, 85, 131, 512]`` per branch); then the
   ``align`` and ``mrrp-align`` slices, the two WSR-50-DC5 YAMLs with
   ``POOLER_TYPE ROIAlignV2`` (the config tree's default pooler; the MRRP
   align routed by branch), and ``align-approx``, the plain one with
   ``TPU.ROI_ALIGN_KERNEL pallas_approx`` (the windowed align); then the int8
   slices ``plain-int8``, ``mrrp-int8`` and ``align-int8``: the plain, MRRP
   and align slices' configs with ``TPU.DAN_FC1_QUANT`` and
   ``TPU.RPN_CONV_QUANT`` ``int8`` (the JAX package's default inference;
   the ROILoopPool's chunk is then 256 channels); then ``swin-fpn`` and
   ``swin-fpn-loop`` on ``wsovod_torch/config/swin_t_fpn.yaml`` (the
   WSR-50-DC5 YAML with Swin-T under a 256-channel FPN, proposals from
   p2-p6, the ROIPool or the ROILoopPool on p2-p5 through the level-routed
   kernels, each ROI on its level; they print the ROIs per pooled level and
   the proposals per RPN level, and hold the five-level top-k and
   level-aware NMS on the card against the same call on CPU copies, on
   seeded candidates at the slice's grids from which proposals survive on
   more than two levels). Each with TTA
   off, bf16 compute, seeded random parameters, B=2 synthetic 688x1056
   images with 4000 SAM proposals each and an 80x512 class-embedding matrix,
   through ``inference_on_dataset``. Checks: the launch counts, set to 0
   just before the run and read just after, rose by one per channel chunk
   and batch for the slice's kernel (the gated ROIPool, routed by branch
   under the MRRP VGG16; the ROIAlign; in the int8 slices the ROIPool's and
   the ROILoopPool's maxabs emission, the align's bf16 kernel; in the Swin
   FPN slices the level-routed ROIPool or ROILoopPool) and stayed 0
   for the others; the int8 GEMMs ran once per fc1 chunk and 9 times per
   RPN level and batch in the int8 slices, never in the others;
   detections are finite and every image has some; the chunks the model
   pooled on the first batch equal the plain version called directly on the
   same card tensors (bit for bit, the maxabs too; the align to float
   tolerance; the int8 slices' on their first 256 ROIs per image); under
   MRRP the RPN's proposals come from more than one branch. An int8 slice also meets the JAX package's int8-vs-float guard
   on its first batch: the ROI heads with fc1 int8 and in bf16 on the same
   features and proposals, pre-NMS class probabilities p99 relative error
   under 3% and each image's top detection within 1 px; it prints its fc1
   and rpn stage times beside the bf16 slice's. Prints
   images/s, the per-stage wall times, peak memory, the RPN input feature's
   standard deviation per copy, and the device's busy share and top device
   times of one batch under ``torch.profiler`` (trace and kernel table in
   ``profiles/``).
6. The gated ROIPool's backward kernel against its plain version at the
   training shape (res5 ``[4, 100, 152, 2048]`` of B=4 800x1216 images,
   5024 ROIs per image from the same box mix plus edge rows, a post-ReLU map
   on a 0.25 grid so bins tie, gate-0 rows), bfloat16 and float32, both
   cotangents: one chunk at full N and every chunk at a reduced N, to float
   tolerance (float32 atomics); its time, the plain version's and the bound.
7. The ROILoopPool's backward kernel against its plain version at the MRRP
   training shape (the three branch copies of res5, ``[12, 100, 152,
   2048]``, the same box mix routed to random branches plus edge, 2-pixel
   and gate-0 rows, a post-ReLU map on a 0.25 grid), bfloat16 and float32,
   both cotangents, one chunk: timed at full N (also with the ROI row
   alone and with the frame), compared on the first 1024 ROIs per image;
   the same map with dead areas (``dead_rects``) and the single-copy call
   (``src`` the image, ``[4, 100, 152, 2048]``, with its own bound), each
   timed at full N and compared on the first 256 ROIs per image; its time,
   the plain version's and the bound. Then the
   gated ROIPool's backward routed by branch, the same way at the MRRP
   VGG16 training shape (plain5's three copies ``[12, 99, 151, 512]``).
   Then the ROIAlign's backward the same way at the training shape and,
   routed, at the MRRP training shape.
8. The ``train-plain`` slice: ``WSOVODTrainer`` on ``WSOVOD_WSR_50_DC5_1x.yaml``
   at full width (``FREEZE_AT`` 5 as shipped, BBOX_REFINE off for want of a
   SAM checkpoint, the recipe scaled to one card: ``BASE_LR`` / 4,
   ``ITER_SIZE`` 4), B=4 synthetic 800x1216 images with 1-4 image-level
   classes, 4000 SAM + 1024 RPN proposals, 8 iterations (2 updates). Checks:
   every loss present and finite on the first and last iteration; frozen
   parameters bit-identical, every trainable one updated (nonzero momentum)
   and the DAN's weights changed; the pool kernel
   launched 4 times per iteration and its backward never (counts set to 0
   just before ``train()`` and read just after); the final checkpoint
   resumes the step, the parameters and the momentum bit for bit. Then ms
   per iteration split into forward / backward / optimizer (forward also
   into backbone / rpn / pool+fc1 / heads+mining+losses), images/s, peak
   memory and the busy share of one profiled iteration.
9. The ``train-res5`` slice: the same as 8. with ``FREEZE_AT`` 4 for 4
   iterations (1 update): res5's weights change and the backward kernel
   launches 4 times per iteration.
10. The ``train-mrrp`` and ``train-mrrp-res5`` slices: the same on
   ``WSOVOD_MRRP_WSR_50_DC5_1x.yaml`` (res5 three times, three anchor
   levels, the ROILoopPool's three rows into the DAN as one batch of rows,
   ContextLocNet's object miner), ``FREEZE_AT`` 5 and 4, 4 iterations each.
   Checks as 8., plus: the loop kernel launched 4 times per iteration with
   3 rows per chunk, the RPN proposing from all three branches, and under
   ``FREEZE_AT`` 4 the loop backward launched 4 times per iteration, the
   model's first launch re-run on a subset of its ROIs against the plain
   version.
11. The ``train-mrrp-vgg`` and ``train-mrrp-vgg-plain5`` slices: the same
   on ``WSOVOD_MRRP_V_16_DC5_1x.yaml`` (plain5 three times, the gated
   ROIPool routed by branch, one chunk per iteration), ``FREEZE_AT`` 5 and
   4, 4 iterations each. Under ``FREEZE_AT`` 4 the JAX package's freeze
   stages train plain1 (no stage rule matches it: stage 5) and plain5, so
   the backward runs through the whole backbone and the routed backward
   launches once per iteration, its first launch re-run against the plain
   version.
12. The ``train-align`` and ``train-align-res5`` slices: the same on
   ``WSOVOD_WSR_50_DC5_1x.yaml`` with ``POOLER_TYPE ROIAlignV2``,
   ``FREEZE_AT`` 5 and 4, 4 iterations each: the align launched 4 times
   per iteration, under ``FREEZE_AT`` 4 its backward too, the model's first
   backward launch re-run on a subset of its ROIs against the plain version.
13. The int8 GEMM times, the card line, one JSON line of kernel records
   (with each kernel's bound on this card computed from this run's inputs;
   the routed pool and its backward, the same kernels with a source copy
   per ROI, have records of their own, as has the routed align; the
   windowed align's times ride in the align's record; each emission mode
   has its own record, the int8 and tile8 ones with no launches, since no
   pooler path reaches them; so has each level-routed mode; the two 2.9
   walks, with no launches and every dtype or case under ``cases``), and
   the result line.

Kernel times are CUDA-event means after a warm-up call, with a spin kernel
holding the card while the host queues the calls (``wsovod_torch.scripts.
cuda_ms``, which the 2.9 entry points share with this script, as they share
the card line and the bound). It imports no JAX and nothing of
``wsovod_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
from wsovod_torch.scripts import PEAK_BYTES_PER_S, bound, card_line, cuda_ms, timed  # noqa: E402
CONFIGS = os.path.join(REPO, "configs", "COCO-Detection")
PLAIN_CONFIG = os.path.join(CONFIGS, "WSOVOD_WSR_50_DC5_1x.yaml")
MRRP_CONFIG = os.path.join(CONFIGS, "WSOVOD_MRRP_WSR_50_DC5_1x.yaml")
VGG_CONFIG = os.path.join(CONFIGS, "WSOVOD_V_16_DC5_1x.yaml")
MRRP_VGG_CONFIG = os.path.join(CONFIGS, "WSOVOD_MRRP_V_16_DC5_1x.yaml")
# the Swin-T FPN detector: the WSR-50-DC5 YAML with Swin-T under an FPN
SWIN_CONFIG = os.path.join(REPO, "wsovod_torch", "config", "swin_t_fpn.yaml")
B, H, W, S = 2, 688, 1056, 4000  # images, test resolution, SAM proposals per image
N_ROIS = 1024 + S  # RPN post-NMS top-k + SAM
FEAT = (B, 86, 132, 2048)  # res5 at stride 8
N_BRANCH = 3  # MRRP branches at test
C_TAKE = 512
N_BATCHES = 3  # timed batches of B images, per slice
REDUCED_N = 256  # ROIs per image where every chunk is checked against the plain pools
TB, TH, TW = 4, 800, 1216  # training: images per iteration and their size
TRAIN_FEAT = (TB, 100, 152, 2048)  # res5 at stride 8
TRAIN_FEAT_MRRP = (N_BRANCH * TB,) + TRAIN_FEAT[1:]  # the three branch copies of res5
TRAIN_ITERS, RES5_ITERS = 8, 4  # iterations of the two plain train slices (ITER_SIZE 4)
MRRP_ITERS, MRRP_RES5_ITERS = 4, 4  # iterations of the two MRRP train slices
LOOP_BWD_PLAIN_N = 1024  # ROIs per image where the loop backward meets its plain version
# ... on the dead-area map and in the single-copy call
LOOP_BWD_DEAD_N = 256
# VGG16-DC5's plain5 at stride 8: plain4's unpadded stride-1 pool takes one
# pixel off H and W; one 512-channel chunk
VGG_FEAT = (B, 85, 131, 512)
VGG_TRAIN_FEAT = (TB, 99, 151, 512)
VGG_ITERS = 4  # iterations of each VGG train slice
ALIGN = "ROIAlignV2"  # the config tree's default pooler, set on the WSR-50-DC5 YAMLs
ALIGN_S = 2  # ROIAlign samples per bin axis: POOLER_SAMPLING_RATIO 0 means 2
ALIGN_ITERS = 4  # iterations of each ROIAlignV2 train slice
ALIGN_BWD_PLAIN_N = 1024  # ROIs per image where the align backward meets its plain version
PROFILE_DIR = os.path.join(REPO, "profiles")  # git-ignored
PEAK_INT8_OPS_PER_S = 1979e12  # NVIDIA H100 SXM data sheet: dense int8 tensor-core rate
C_TAKE_LOOP_INT8 = 256  # the ROILoopPool's chunk with the int8 fc1, the JAX pooler's
INT8_C_TILE = 256  # the int8 emissions' quantization tile in the emission phase
# the Swin FPN's pooled levels p2-p5 at 688x1056 (PatchMerging pads odd sides)
# and their scales; 256 channels, one chunk
SWIN_LEVELS = ((B, 172, 264, 256), (B, 86, 132, 256), (B, 43, 66, 256), (B, 22, 33, 256))
SWIN_SCALES = (0.25, 0.125, 0.0625, 0.03125)


def log(*a):
    print(*a, flush=True)


def box_mix(rng, b, s, w=W, h=H):
    """The ``bench.py`` SAM-like long-tail box mix: 80% U(8,300) px sides,
    15% U(300,700), 5% near image scale; clipped to the image."""
    u = rng.rand(b, s, 1)
    wh = np.where(
        u < 0.80, rng.uniform(8, 300, (b, s, 2)),
        np.where(u < 0.95, rng.uniform(300, 700, (b, s, 2)),
                 np.stack([rng.uniform(0.7, 1.0, (b, s)) * w,
                           rng.uniform(0.7, 1.0, (b, s)) * h], -1)))
    xy = rng.uniform(0, w * 0.6, (b, s, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[..., [0, 2]] = boxes[..., [0, 2]].clip(0, w)
    boxes[..., [1, 3]] = boxes[..., [1, 3]].clip(0, h)
    return boxes.astype(np.float32)


def pool_inputs(rng, b=B, w=W, h=H):
    """The slice's ROIs per image with edge rows, and the
    ``(objectness+1)*valid`` gate; invalid rows zeroed."""
    rois = box_mix(rng, b, N_ROIS, w, h)
    rois[:, 0] = [w - 40, h - 100, w + 160, h + 240]  # overhangs right and bottom
    rois[:, 1] = [-60, -30, 200, 150]  # overhangs left and top
    rois[:, 2] = [500, 400, 300, 200]  # degenerate: x2 < x1, y2 < y1
    rois[:, 3] = [4, 12, 100, 60]  # .5 boundaries at stride 8
    rois[:, 4] = [20, 28, 60, 68]  # outer box on .5 boundaries
    valid = rng.rand(b, N_ROIS) > 0.1
    valid[:, :5] = True
    gate = ((rng.rand(b, N_ROIS) + 1.0) * valid).astype(np.float32)
    rois = np.where(valid[..., None], rois, 0.0).astype(np.float32)
    return rois, gate


def bin_pixels(rp, region, hole, p, h_lim, w_lim):
    """Feature pixels each bin's max must read, ``[..., P, P]``: the bins of
    the rounded ``region (x1, y1, w, h)`` clipped to the map, less the strict
    interior of ``hole (x1, y1, x2, y2)`` where one is given."""
    hlo, hhi = rp._bin_edges(region[..., 1], region[..., 3], p, h_lim)
    wlo, whi = rp._bin_edges(region[..., 0], region[..., 2], p, w_lim)
    bh, bw = (hhi - hlo).clamp(min=0).long(), (whi - wlo).clamp(min=0).long()
    count = bh[..., :, None] * bw[..., None, :]
    if hole is not None:
        oh = (hhi.minimum(hole[..., 3, None]) - hlo.maximum(hole[..., 1, None] + 1)).clamp(min=0)
        ow = (whi.minimum(hole[..., 2, None]) - wlo.maximum(hole[..., 0, None] + 1)).clamp(min=0)
        count = count - oh.long()[..., :, None] * ow.long()[..., None, :]
    return count


def hollow_set_pixels(rp, region, hole, p, h_lim, w_lim):
    """Pixels of the two masked sets of each frame or context bin, ``[...,
    P, P]``: the bin's rows x its columns outside the hole's column interior,
    plus its rows outside the hole's row interior x its columns (a pixel in
    both counts twice: the backward visits both sets)."""
    hlo, hhi = rp._bin_edges(region[..., 1], region[..., 3], p, h_lim)
    wlo, whi = rp._bin_edges(region[..., 0], region[..., 2], p, w_lim)
    bh, bw = (hhi - hlo).clamp(min=0).long(), (whi - wlo).clamp(min=0).long()
    oh = (hhi.minimum(hole[..., 3, None]) - hlo.maximum(hole[..., 1, None] + 1)).clamp(min=0).long()
    ow = (whi.minimum(hole[..., 2, None]) - wlo.maximum(hole[..., 0, None] + 1)).clamp(min=0).long()
    return bh[..., :, None] * (bw - ow)[..., None, :] + (bh - oh)[..., :, None] * bw[..., None, :]


def near(got, want, rtol, atol=1e-5):
    """``(ok, max |err|)``: |got - want| <= rtol |want| + atol max |want|,
    and ``want`` not all zero (float32 sums or atomics in another order:
    rtol 1e-5, or one bfloat16 step, 2**-7, where the result is rounded to
    bfloat16; a gate cotangent, a sum over a whole ROI, rtol and atol
    1e-4)."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max()
    return bool(scale > 0 and (err <= rtol * want.float().abs() + atol * scale).all()), \
        err.max().item()


def dead_rects(torch, feat, seed, count=6):
    """A copy of the map ``feat [S, H, W, C]`` with ``count`` all-zero
    rectangles per copy, in every channel, each 12-40 rows by 16-64 columns
    at seeded places: dead areas larger than a bin, so whole sets tie at 0,
    as on a post-ReLU map."""
    rng = np.random.RandomState(seed)
    s, h, w = feat.shape[:3]
    out = feat.clone()
    for k in range(s):
        for _ in range(count):
            rh, rw = rng.randint(12, 41), rng.randint(16, 65)
            y, x = rng.randint(0, h - rh + 1), rng.randint(0, w - rw + 1)
            out[k, y:y + rh, x:x + rw] = 0
    return out


def phase_pool_kernel(torch, dev, rp):
    """Gated ROIPool kernel vs plain at the plain slice's shapes."""
    rois, gate = pool_inputs(np.random.RandomState(0))
    rois_t = torch.from_numpy(rois).to(dev)
    gate_t = torch.from_numpy(gate).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    feat32 = torch.randn(FEAT, generator=g, device=dev)
    max_err, ms, plain_ms = 0.0, None, None
    for dtype, chunks in ((torch.bfloat16, range(0, FEAT[3], C_TAKE)), (torch.float32, [C_TAKE])):
        feat = feat32.to(dtype).contiguous()
        for c_base in chunks:
            got = rp.roi_pool_gated(feat, rois_t, gate_t, c_base, C_TAKE, 7, 0.125)
            want, t = timed(lambda: rp.roi_pool_gated_plain(feat, rois_t, gate_t, c_base, C_TAKE, 7,
                                                            0.125, max_elems=1 << 28))
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(f"roi_pool_gated != plain ({dtype}, c_base {c_base}): "
                                     f"max |err| {err}")
            if dtype == torch.bfloat16 and c_base == C_TAKE:
                plain_ms = t
        if dtype == torch.bfloat16:
            ms = cuda_ms(lambda: rp.roi_pool_gated(feat, rois_t, gate_t, C_TAKE, C_TAKE, 7, 0.125), 20)
        log(f"roi_pool_gated == plain, {str(dtype)[6:]}, chunks at {list(chunks)}: exact")
    region = rp.round_region(rois_t, 0.125)
    pixels = int(bin_pixels(rp, region, None, 7, FEAT[1], FEAT[2]).sum()) * C_TAKE
    out_elems = B * N_ROIS * 49 * C_TAKE
    in_bytes = B * FEAT[1] * FEAT[2] * C_TAKE * 2 + rois_t.numel() * 4 + gate_t.numel() * 4
    bound_ms, bound_by = bound(pixels + out_elems, in_bytes, out_elems * 2)
    log(f"roi_pool_gated bf16 {list(FEAT)} x {N_ROIS} ROIs, one 512-channel chunk: kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
        f"{(in_bytes + out_elems * 2) / 1e6:.1f} MB, {pixels / 1e9:.3f} G compares)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def loop_bound(torch, rp, rois_t, src_t, rows, esize=2):
    """``(bound_ms, bound_by, bytes, compares)`` of one loop-pool chunk call
    with ``rows`` rows; only the feature copies that some ROI reads count."""
    geo = rp.loop_geometry(rois_t, 0.125, FEAT[1], FEAT[2], 1.8)
    parts = [(geo[..., 0:4], None), (geo[..., 0:4], geo[..., 8:12]), (geo[..., 4:8], geo[..., 12:16])]
    pixels = sum(int(bin_pixels(rp, reg, hole, 7, FEAT[1], FEAT[2]).sum())
                 for reg, hole in parts[:rows]) * C_TAKE
    copies = int(torch.unique(src_t).numel())
    out_elems = rows * B * N_ROIS * 49 * C_TAKE
    in_bytes = (copies * FEAT[1] * FEAT[2] * C_TAKE * esize
                + rois_t.numel() * 4 + 2 * src_t.numel() * 4)  # + rois, gate and src
    bound_ms, bound_by = bound(pixels + out_elems, in_bytes, out_elems * esize)
    return bound_ms, bound_by, in_bytes + out_elems * esize, pixels


def phase_loop_kernel(torch, dev, rp):
    """Branch-routed ROILoopPool kernel vs plain at the MRRP slice's shapes."""
    rng = np.random.RandomState(1)
    rois, gate = pool_inputs(rng)
    branch = rng.randint(0, N_BRANCH, (B, N_ROIS))
    branch[:, :N_BRANCH] = np.arange(N_BRANCH)
    src = (branch * B + np.arange(B)[:, None]).astype(np.int32)
    rois_t, gate_t, src_t = (torch.from_numpy(a).to(dev) for a in (rois, gate, src))
    g = torch.Generator(device=dev).manual_seed(1)
    feat32 = torch.randn((N_BRANCH * B,) + FEAT[1:], generator=g, device=dev)
    n = REDUCED_N
    max_err, times = 0.0, {}

    def check(feat, rows, c_base, rois_, gate_, src_, what):
        nonlocal max_err
        got = rp.roi_loop_pool_gated(feat, rois_, gate_, src_, c_base, C_TAKE, rows, 7, 0.125)
        want, t = timed(lambda: rp.roi_loop_pool_gated_plain(
            feat, rois_, gate_, src_, c_base, C_TAKE, rows, 7, 0.125, 1.8, max_elems=1 << 28))
        err = (got.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"roi_loop_pool_gated != plain ({what}): max |err| {err}")
        return got, t

    for dtype in (torch.bfloat16, torch.float32):
        feat = feat32.to(dtype).contiguous()
        name = str(dtype)[6:]
        full3, t3 = check(feat, 3, C_TAKE, rois_t, gate_t, src_t, f"{name}, rows 3, full N")
        if dtype == torch.bfloat16:
            full1, t1 = check(feat, 1, C_TAKE, rois_t, gate_t, src_t, f"{name}, rows 1, full N")
            if not torch.equal(full1[0], full3[0]):
                raise AssertionError("rows=1 differs from row 0 of rows=3")
            times.update(plain_ms=t1, plain_rows3_ms=t3)
            times["ms"] = cuda_ms(lambda: rp.roi_loop_pool_gated(
                feat, rois_t, gate_t, src_t, C_TAKE, C_TAKE, 1, 7, 0.125), 20)
            times["rows3_ms"] = cuda_ms(lambda: rp.roi_loop_pool_gated(
                feat, rois_t, gate_t, src_t, C_TAKE, C_TAKE, 3, 7, 0.125), 10)
        for c_base in range(0, FEAT[3], C_TAKE):
            check(feat, 3, c_base, rois_t[:, :n].contiguous(), gate_t[:, :n].contiguous(),
                  src_t[:, :n].contiguous(), f"{name}, rows 3, {n} ROIs, c_base {c_base}")
        log(f"roi_loop_pool_gated == plain, {name}: rows 3 (and 1) at {N_ROIS} ROIs on one chunk, "
            f"rows 3 at {n} ROIs on chunks {list(range(0, FEAT[3], C_TAKE))}: exact; rows=1 == "
            f"row 0 of rows=3")
    bound_ms, bound_by, nbytes, pixels = loop_bound(torch, rp, rois_t, src_t, 1)
    b3_ms, b3_by, b3_bytes, b3_pixels = loop_bound(torch, rp, rois_t, src_t, 3)
    log(f"roi_loop_pool_gated bf16 {[N_BRANCH * B] + list(FEAT[1:])} x {N_ROIS} ROIs, one "
        f"512-channel chunk: rows 1 kernel {times['ms']:.3f} ms, plain {times['plain_ms']:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {pixels / 1e9:.3f} G "
        f"compares); rows 3 kernel {times['rows3_ms']:.3f} ms, plain {times['plain_rows3_ms']:.3f} "
        f"ms, bound {b3_ms:.3f} ms ({b3_by}: {b3_bytes / 1e6:.1f} MB, {b3_pixels / 1e9:.3f} G "
        f"compares)")
    return {"max_abs_err": max_err, "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by}


def routed_inputs(rng, b, w, h):
    """``pool_inputs`` plus each ROI's source copy ``branch * b + image``,
    the branch drawn from ``rng`` (every branch read)."""
    rois, gate = pool_inputs(rng, b, w, h)
    branch = rng.randint(0, N_BRANCH, (b, N_ROIS))
    branch[:, :N_BRANCH] = np.arange(N_BRANCH)
    return rois, gate, (branch * b + np.arange(b)[:, None]).astype(np.int32)


def phase_routed_kernel(torch, dev, rp):
    """The gated ROIPool routed by branch (``src``) vs its plain version at
    the MRRP VGG16 slice's shapes: plain5's three branch copies ``[6, 85,
    131, 512]``, the slice's ROIs, each on a branch drawn from a seed;
    bfloat16 and float32, bit for bit; both times and the bound."""
    rois, gate, src = routed_inputs(np.random.RandomState(5), B, W, H)
    rois_t, gate_t, src_t = (torch.from_numpy(a).to(dev) for a in (rois, gate, src))
    g = torch.Generator(device=dev).manual_seed(5)
    feat32 = torch.randn((N_BRANCH * B,) + VGG_FEAT[1:], generator=g, device=dev)
    max_err, times = 0.0, {}
    for dtype in (torch.bfloat16, torch.float32):
        feat = feat32.to(dtype).contiguous()
        got = rp.roi_pool_gated(feat, rois_t, gate_t, 0, C_TAKE, 7, 0.125, src_t)
        want, t = timed(lambda: rp.roi_pool_gated_plain(feat, rois_t, gate_t, 0, C_TAKE, 7, 0.125,
                                                        max_elems=1 << 28, src=src_t))
        err = (got.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"routed roi_pool_gated != plain ({dtype}): max |err| {err}")
        if dtype == torch.bfloat16:
            times["plain_ms"] = t
            times["ms"] = cuda_ms(lambda: rp.roi_pool_gated(feat, rois_t, gate_t, 0, C_TAKE, 7,
                                                            0.125, src_t), 20)
        log(f"roi_pool_gated routed == plain, {str(dtype)[6:]}, {N_ROIS} ROIs per image: exact")
    region = rp.round_region(rois_t, 0.125)
    pixels = int(bin_pixels(rp, region, None, 7, VGG_FEAT[1], VGG_FEAT[2]).sum()) * C_TAKE
    copies = int(torch.unique(src_t).numel())
    out_elems = B * N_ROIS * 49 * C_TAKE
    in_bytes = (copies * VGG_FEAT[1] * VGG_FEAT[2] * C_TAKE * 2 + rois_t.numel() * 4
                + gate_t.numel() * 4 + src_t.numel() * 4)
    bound_ms, bound_by = bound(pixels + out_elems, in_bytes, out_elems * 2)
    log(f"roi_pool_gated routed bf16 {[N_BRANCH * B] + list(VGG_FEAT[1:])} x {N_ROIS} ROIs, one "
        f"512-channel chunk: kernel {times['ms']:.3f} ms, plain {times['plain_ms']:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}: {(in_bytes + out_elems * 2) / 1e6:.1f} MB, "
        f"{pixels / 1e9:.3f} G compares)")
    return {"max_abs_err": max_err, "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_level_kernels(torch, dev, rp):
    """The level-routed ROIPool and ROILoopPool (kernel 2.5) vs their plain
    versions at the ``swin-fpn`` slices' level shapes (p2 ``[2, 172, 264,
    256]`` to p5 ``[2, 22, 33, 256]``), the slice's 5024 ROIs per image
    (the box mix plus overhanging, degenerate and invalid rows), each on the
    level d2's rule assigns it: bfloat16 and float32, the loop rows 1 and 3,
    bit for bit; times and bounds (the bound reads each level's chunk once
    and the bins' pixels of each ROI on its own level)."""
    from wsovod_torch.models.poolers import assign_boxes_to_levels

    rois, gate = pool_inputs(np.random.RandomState(10))
    rois_t, gate_t = (torch.from_numpy(a).to(dev) for a in (rois, gate))
    g = torch.Generator(device=dev).manual_seed(10)
    f32 = [torch.randn(sh, generator=g, device=dev) for sh in SWIN_LEVELS]
    level = assign_boxes_to_levels(rois_t, 2, 5)
    per_level = torch.bincount(level.flatten(), minlength=len(SWIN_LEVELS)).tolist()
    c = SWIN_LEVELS[0][3]
    records = {name: {"max_abs_err": 0.0} for name in ("roi_pool_levels", "roi_loop_pool_levels")}

    def check(name, fn, plain, dtype, what):
        got = fn()
        want, t = timed(plain)
        err = (got.float() - want.float()).abs().max().item()
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} != plain ({what}): max |err| {err}")
        return t

    for dtype in (torch.bfloat16, torch.float32):
        feats = [f.to(dtype).contiguous() for f in f32]
        name = str(dtype)[6:]
        t = check("roi_pool_levels",
                  lambda: rp.roi_pool_levels(feats, rois_t, gate_t, level, 0, c, 7, SWIN_SCALES),
                  lambda: rp.roi_pool_levels_plain(feats, rois_t, gate_t, level, 0, c, 7,
                                                   SWIN_SCALES, max_elems=1 << 28), dtype, name)
        if dtype == torch.bfloat16:
            records["roi_pool_levels"]["plain_ms"] = t
            records["roi_pool_levels"]["ms"] = cuda_ms(lambda: rp.roi_pool_levels(
                feats, rois_t, gate_t, level, 0, c, 7, SWIN_SCALES), 20)
        for rows in (1, 3):
            t = check("roi_loop_pool_levels",
                      lambda: rp.roi_loop_pool_levels(feats, rois_t, gate_t, level, 0, c, rows, 7,
                                                      SWIN_SCALES),
                      lambda: rp.roi_loop_pool_levels_plain(feats, rois_t, gate_t, level, 0, c,
                                                            rows, 7, SWIN_SCALES,
                                                            max_elems=1 << 28),
                      dtype, f"{name}, rows {rows}")
            if dtype == torch.bfloat16:
                key = "" if rows == 1 else "rows3_"
                records["roi_loop_pool_levels"][f"{key}plain_ms"] = t
                records["roi_loop_pool_levels"][f"{key}ms"] = cuda_ms(
                    lambda: rp.roi_loop_pool_levels(feats, rois_t, gate_t, level, 0, c, rows, 7,
                                                    SWIN_SCALES), 20 if rows == 1 else 10)
        log(f"roi_pool_levels and roi_loop_pool_levels (rows 1, 3) == plain, {name}, {N_ROIS} "
            f"ROIs per image on levels p2-p5 {per_level}: exact")

    # the bound: each level's chunk read once (bf16), the ROIs, gate and
    # level; the output written once; one compare per bin pixel of each ROI
    # on its own level and channel, one gate multiply per output
    scale_t = rp.level_scales(level, SWIN_SCALES)
    region = rp.round_region(rois_t, scale_t)
    geo = rp.level_loop_geometry(rois_t, level, SWIN_SCALES, [sh[1:3] for sh in SWIN_LEVELS], 1.8)
    in_bytes = (sum(sh[0] * sh[1] * sh[2] * c * 2 for sh in SWIN_LEVELS) + rois_t.numel() * 4
                + 2 * gate_t.numel() * 4)
    for name, parts in (("roi_pool_levels", [(region, None)]),
                        ("roi_loop_pool_levels", [(geo[..., 0:4], None)])):
        pixels = 0
        for lvl, sh in enumerate(SWIN_LEVELS):
            on = level == lvl
            for reg, hole in parts:
                pixels += int(bin_pixels(rp, reg[on], hole, 7, sh[1], sh[2]).sum()) * c
        out_elems = B * N_ROIS * 49 * c
        bound_ms, bound_by = bound(pixels + out_elems, in_bytes, out_elems * 2)
        r = records[name]
        r.update(bound_ms=bound_ms, bound_by=bound_by, rois_per_level=per_level)
        log(f"{name} bf16 levels {[list(sh) for sh in SWIN_LEVELS]} x {N_ROIS} ROIs, one "
            f"{c}-channel chunk{', rows 1' if 'loop' in name else ''}: kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
            f"{(in_bytes + out_elems * 2) / 1e6:.1f} MB, {pixels / 1e9:.3f} G compares)"
            + (f"; rows 3 kernel {r['rows3_ms']:.3f} ms, plain {r['rows3_plain_ms']:.3f} ms"
               if "loop" in name else ""))
    return records


def exact(got, want):
    """``(equal, max |err|)`` of two tuples of tensors (payloads and scales)."""
    ok = all(a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())
             for a, b in zip(got, want))
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    return ok, err


def pool_bytes(copies, feat_hw, c_take, rois_t, extra_in=0):
    """Bytes a pool call must read: the feature chunk of the copies some ROI
    reads, in bfloat16, the ROIs and the gate (and ``extra_in``)."""
    return copies * feat_hw[0] * feat_hw[1] * c_take * 2 + rois_t.numel() * 4 + (
        rois_t.numel() // 4) * 4 + extra_in


def phase_emission_kernels(torch, dev, rp, ra):
    """The emission modes of the pool kernels against their plain versions
    at the slices' shapes, bit for bit (payloads and scales), bfloat16 and
    float32 (see the module docstring); kernel and plain times (bfloat16)
    and bounds. Returns a record per kernel."""
    rois, gate = pool_inputs(np.random.RandomState(0))
    rois_t, gate_t = torch.from_numpy(rois).to(dev), torch.from_numpy(gate).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    feat32 = torch.randn(FEAT, generator=g, device=dev)
    rng = np.random.RandomState(1)
    rois_l, gate_l = pool_inputs(rng)
    branch = rng.randint(0, N_BRANCH, (B, N_ROIS))
    branch[:, :N_BRANCH] = np.arange(N_BRANCH)
    src_l = (branch * B + np.arange(B)[:, None]).astype(np.int32)
    rl_t, gl_t, sl_t = (torch.from_numpy(a).to(dev) for a in (rois_l, gate_l, src_l))
    feat_l32 = torch.randn((N_BRANCH * B,) + FEAT[1:], generator=g, device=dev)
    rois_a, gate_a = align_inputs(np.random.RandomState(8), B, W, H)
    ra_t, ga_t = torch.from_numpy(rois_a).to(dev), torch.from_numpy(gate_a).to(dev)
    n, ct, cl = REDUCED_N, INT8_C_TILE, C_TAKE_LOOP_INT8

    def sub(*ts):
        return [t[:, :n].contiguous() for t in ts]

    # name: (kernel, plain, feature, [(what, args)], c_take); the first check
    # runs at full N in bfloat16 (and is timed), at a reduced N in float32
    cases = {
        "roi_pool_gated_maxabs": (
            rp.roi_pool_gated_maxabs, rp.roi_pool_gated_maxabs_plain, feat32,
            [("full N", (rois_t, gate_t, C_TAKE, C_TAKE, 7, 0.125))], C_TAKE),
        "roi_pool_gated_int8": (
            rp.roi_pool_gated_int8, rp.roi_pool_gated_int8_plain, feat32,
            [("full N", (rois_t, gate_t, C_TAKE, C_TAKE, ct, 7, 0.125))], C_TAKE),
        "roi_pool_gated_tile8": (
            rp.roi_pool_gated_tile8, rp.roi_pool_gated_tile8_plain, feat32,
            [("full N", (rois_t, gate_t, C_TAKE, C_TAKE, 7, 0.125))], C_TAKE),
        "roi_loop_pool_gated_maxabs": (
            rp.roi_loop_pool_gated_maxabs, rp.roi_loop_pool_gated_maxabs_plain, feat_l32,
            [("rows 1, full N", (rl_t, gl_t, sl_t, cl, cl, 1, 7, 0.125)),
             ("rows 3", (*sub(rl_t, gl_t, sl_t), cl, cl, 3, 7, 0.125))], cl),
        "roi_loop_pool_gated_int8": (
            rp.roi_loop_pool_gated_int8, rp.roi_loop_pool_gated_int8_plain, feat_l32,
            [("rows 1, full N", (rl_t, gl_t, sl_t, C_TAKE, C_TAKE, ct, 1, 7, 0.125)),
             ("rows 3", (*sub(rl_t, gl_t, sl_t), C_TAKE, C_TAKE, ct, 3, 7, 0.125))], C_TAKE),
        "roi_align_gated_int8": (
            ra.roi_align_gated_int8, ra.roi_align_gated_int8_plain, feat32,
            [("full N", (ra_t, ga_t, C_TAKE, C_TAKE, ct, 7, 0.125, ALIGN_S)),
             ("routed, windowed", (*sub(ra_t, ga_t), C_TAKE, C_TAKE, ct, 7, 0.125, ALIGN_S,
                                   True, sub(sl_t)[0], ra.WINDOW))], C_TAKE),
    }
    records = {}
    for name, (kernel, plain, f32, checks, c_take) in cases.items():
        max_err, times = 0.0, {}
        for dtype in (torch.bfloat16, torch.float32):
            feat = f32.to(dtype).contiguous()
            routed_align = name == "roi_align_gated_int8"
            for what, args in checks:
                # the routed align reads three copies: the loop pool's feature
                f_ = feat_l32.to(dtype).contiguous() if routed_align and what != "full N" else feat
                if dtype == torch.float32 and what == checks[0][0]:  # its ROI tensors at n
                    args = tuple(sub(a)[0] if torch.is_tensor(a) and a.dim() >= 2 else a
                                 for a in args)
                got = kernel(f_, *args)
                want, t = timed(lambda: plain(f_, *args))
                ok, err = exact(got, want)
                max_err = max(max_err, err)
                if not ok:
                    raise AssertionError(f"{name} != plain ({str(dtype)[6:]}, {what}): max |err| "
                                         f"{err}")
                if dtype == torch.bfloat16 and what == checks[0][0]:
                    times["plain_ms"] = t
                    times["ms"] = cuda_ms(lambda: kernel(f_, *args), 20)
            if name == "roi_pool_gated_maxabs":  # the payload is the gated pool's, bit for bit
                if not torch.equal(got[0], rp.roi_pool_gated(feat, *args)):
                    raise AssertionError(f"roi_pool_gated_maxabs payload != roi_pool_gated "
                                         f"({dtype})")
        # least time: read the chunk of the copies some ROI reads, rois, gate
        # (and src) once, write the payload (2 B, or 1 B int8) and the scales
        # once; a compare per bin pixel and channel (the align: a multiply
        # and an add per nonzero corner term), an epilogue op per output
        out_elems = B * N_ROIS * 49 * c_take
        n_ct = c_take // ct
        if name.startswith("roi_align"):
            terms = align_terms(ra, ra_t, FEAT[1], FEAT[2])
            work, in_bytes = 2 * terms * c_take + out_elems, pool_bytes(B, FEAT[1:3], c_take, ra_t)
        elif name.startswith("roi_loop"):
            geo = rp.loop_geometry(rl_t, 0.125, FEAT[1], FEAT[2], 1.8)
            work = int(bin_pixels(rp, geo[..., 0:4], None, 7, FEAT[1], FEAT[2]).sum()) * c_take
            copies = int(torch.unique(sl_t).numel())
            in_bytes = pool_bytes(copies, FEAT[1:3], c_take, rl_t, sl_t.numel() * 4)
        else:
            region = rp.round_region(rois_t, 0.125)
            work = int(bin_pixels(rp, region, None, 7, FEAT[1], FEAT[2]).sum()) * c_take
            in_bytes = pool_bytes(B, FEAT[1:3], c_take, rois_t)
        out_bytes = (out_elems * 2 + B * N_ROIS * 4 if name.endswith("maxabs")
                     else out_elems + B * N_ROIS * 4 * (1 if name.endswith("tile8") else n_ct))
        bound_ms, bound_by = bound(work + out_elems, in_bytes, out_bytes)
        log(f"{name} == plain, bfloat16 and float32 ({', '.join(w for w, _ in checks)}; float32 "
            f"{n} ROIs per image for the first): exact; "
            f"bf16 one {c_take}-channel chunk{f', c_tile {ct}' if 'int8' in name else ''}: kernel "
            f"{times['ms']:.3f} ms, plain {times['plain_ms']:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}: {(in_bytes + out_bytes) / 1e6:.1f} MB, {(work + out_elems) / 1e9:.3f} G "
            f"operations)")
        records[name] = {"max_abs_err": max_err, "bound_ms": bound_ms, "bound_by": bound_by,
                         "launches": 0, **times}
    return records


def phase_walk_kernels(torch, dev, fold, walk):
    """Kernel 2.9 (see the module docstring): ``fold.measure`` in every
    dtype and ``walk.measure`` in every case, each holding the kernel's
    result bit for bit against its plain version; each quarter-count time at
    most 0.4 of the full count's. Returns a record per kernel with the
    bfloat16 fold's and case A's numbers, every dtype or case under
    ``cases``."""
    cases = {"row_fold": {}, "row_walk": {}}
    for name, dtype in fold.DTYPES:
        cases["row_fold"][name.strip()] = rec = fold.measure(fold.make_map(dtype, dev))
        log(f"row_fold {fold.line(name, rec)}")
    feats, hlo, x0 = walk.make_inputs(dev)
    for name, dt, win in walk.CASES:
        cases["row_walk"][name.strip()] = rec = walk.measure(feats[dt], hlo, x0[name], win)
        log(f"row_walk {walk.line(name, rec)}")
    records = {}
    for kernel, top in (("row_fold", "bf16"), ("row_walk", "A bf16 fullrow")):
        slow = {k: r["quarter_ratio"] for k, r in cases[kernel].items() if r["quarter_ratio"] > 0.4}
        if slow:
            raise AssertionError(f"{kernel}: a quarter of the walk took more than 0.4 of the "
                                 f"whole: {slow}")
        r = cases[kernel][top]
        records[kernel] = {"launches": 0, "max_abs_err": max(c["max_abs_err"] for c in
                                                             cases[kernel].values()),
                           **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                           "cases": cases[kernel]}
    del feats, hlo, x0
    torch.cuda.empty_cache()
    return records


def phase_int8_gemms(torch, dev):
    """The int8 fc1 and RPN conv of the slices (``torch._int_mm``, cuBLASLt's
    int8 GEMM, as the JAX package left its int8 einsums to XLA) against
    their floating-point counterparts at the slices' shapes: one fc1 chunk
    ``[B * N, 49 * 512] x [49 * 512, 4096]`` and the RPN's 3x3 conv on
    ``[2, 86, 132, 2048]``, bfloat16 activations; times only."""
    from wsovod_torch.models.box_head import ChunkedLinear
    from wsovod_torch.models.layers import QuantizableConv3x3, int_mm

    g = torch.Generator(device=dev).manual_seed(4)
    fc1 = ChunkedLinear(FEAT[3], 7, 4096, C_TAKE, quant="int8").to(dev)
    with torch.no_grad():
        fc1.weight.normal_(0.0, 0.005, generator=g)
    x = torch.randn((B, N_ROIS, 7, 7, C_TAKE), generator=g, device=dev).to(torch.bfloat16)
    a8 = torch.randint(-127, 128, (B * N_ROIS, 49 * C_TAKE), generator=g, device=dev,
                       dtype=torch.int8)
    with torch.inference_mode():
        w8, _ = fc1.quantized_weight(0)
        out = {"fc1_int8_gemm_ms": cuda_ms(lambda: int_mm(a8, w8), 10),
               "fc1_int8_chunk_ms": cuda_ms(lambda: fc1(x, 0, int8=True), 10),
               "fc1_bf16_chunk_ms": cuda_ms(lambda: fc1(x, 0), 10)}
        conv = QuantizableConv3x3(FEAT[3], FEAT[3], "int8").to(dev)
        feat = torch.randn(FEAT, generator=g, device=dev).to(torch.bfloat16)
        out["rpn_conv_int8_ms"] = cuda_ms(lambda: conv.forward_nhwc(feat, int8=True), 5)
        out["rpn_conv_bf16_ms"] = cuda_ms(lambda: conv.forward_nhwc(feat), 5)
    ops = 2 * B * N_ROIS * 49 * C_TAKE * 4096
    gemm_bound = max(ops / PEAK_INT8_OPS_PER_S,
                     (a8.numel() + w8.numel() + B * N_ROIS * 4096 * 4) / PEAK_BYTES_PER_S) * 1e3
    log(f"fc1 chunk [{B * N_ROIS}, {49 * C_TAKE}] x [{49 * C_TAKE}, 4096]: int8 GEMM (torch._int_mm) "
        f"{out['fc1_int8_gemm_ms']:.3f} ms (bound {gemm_bound:.3f} ms at 1979 TOP/s int8), the int8 "
        f"chunk with its activation quantize {out['fc1_int8_chunk_ms']:.3f} ms, the bf16 chunk "
        f"{out['fc1_bf16_chunk_ms']:.3f} ms; RPN 3x3 conv on {list(FEAT)}: int8 (9 shifted GEMMs) "
        f"{out['rpn_conv_int8_ms']:.3f} ms, bf16 (cuDNN) {out['rpn_conv_bf16_ms']:.3f} ms")
    return out


def align_terms(ra, rois_t, h, w):
    """Corner terms per channel that a call's ROIAlign needs, summed over
    its ROIs: per ROI, (sample rows' nonzero corner weights) x (sample
    columns'), the nonzero products of the sample metadata; a term is a
    multiply and an add per channel."""
    _, wt = ra.sample_meta(rois_t, 0.125, 7, ALIGN_S, True, h, w)
    nz = (wt != 0).sum(dim=(-2, -1)).long()  # [..., 2]: nonzero weights along y and x
    return int((nz[..., 0] * nz[..., 1]).sum())


def align_inputs(rng, b, w, h):
    """``pool_inputs`` plus a zero-area row and a valid row of gate 0."""
    rois, gate = pool_inputs(rng, b, w, h)
    rois[:, 5] = [300, 200, 300, 200]  # zero area
    rois[:, 6] = [100, 100, 500, 400]
    gate[:, 6] = 0.0  # a valid box with gate 0
    return rois, gate


def phase_align_kernel(torch, dev, ra):
    """The gated ROIAlign kernel vs its plain version at the ``align``
    slice's shapes (res5 ``[2, 86, 132, 2048]``) and, routed by branch, at
    the ``mrrp-align`` slice's (``[6, 86, 132, 2048]``): 5024 ROIs per image
    from the box mix with overhanging, degenerate, zero-area, invalid and
    gate-0 rows, ``sampling_ratio`` 2, bfloat16 and float32, exact and
    windowed (``TPU.ROI_ALIGN_KERNEL = "pallas_approx"``): one chunk at full
    N, every chunk at a reduced N. Tolerance: float32 sums in another order,
    |kernel - plain| <= rtol |plain| + 1e-5 max |plain|, rtol 1e-5 in
    float32 and one bfloat16 step (2**-7) in bfloat16. Returns the records
    of the unrouted and the routed kernel."""
    rng = np.random.RandomState(8)
    rois, gate = align_inputs(rng, B, W, H)
    branch = rng.randint(0, N_BRANCH, (B, N_ROIS))
    branch[:, :N_BRANCH] = np.arange(N_BRANCH)
    src = (branch * B + np.arange(B)[:, None]).astype(np.int32)
    rois_t, gate_t, src_t = (torch.from_numpy(a).to(dev) for a in (rois, gate, src))
    g = torch.Generator(device=dev).manual_seed(8)
    feat32 = torch.randn((N_BRANCH * B,) + FEAT[1:], generator=g, device=dev)
    n = REDUCED_N
    records = {}
    for name, copies, s_t in (("roi_align_gated", B, None), ("roi_align_gated_routed", N_BRANCH * B,
                                                              src_t)):
        max_err, times = 0.0, {}
        sub = [rois_t[:, :n].contiguous(), gate_t[:, :n].contiguous(),
               None if s_t is None else s_t[:, :n].contiguous()]
        for dtype, rtol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
            feat = feat32[:copies].to(dtype).contiguous()
            dn = str(dtype)[6:]
            for window in (None, ra.WINDOW):
                what = f"{name}, {dn}, {'windowed' if window else 'exact'}"
                checks = [(C_TAKE, rois_t, gate_t, s_t, "full N")] + [
                    (c, *sub, f"{n} ROIs") for c in range(0, FEAT[3], C_TAKE)]
                for c_base, r_, g_, sr, where in checks:
                    got = ra.roi_align_gated(feat, r_, g_, c_base, C_TAKE, 7, 0.125, ALIGN_S,
                                             src=sr, window=window)
                    want, t = timed(lambda: ra.roi_align_gated_plain(
                        feat, r_, g_, c_base, C_TAKE, 7, 0.125, ALIGN_S, src=sr, window=window,
                        max_elems=1 << 27))
                    ok, err = near(got, want, rtol)
                    max_err = max(max_err, err)
                    if not ok:
                        raise AssertionError(f"{what} != plain ({where}, c_base {c_base}): max "
                                             f"|err| {err}")
                    if dtype == torch.bfloat16 and where == "full N":
                        times["window_plain_ms" if window else "plain_ms"] = t
                if dtype == torch.bfloat16:
                    times["window_ms" if window else "ms"] = cuda_ms(lambda: ra.roi_align_gated(
                        feat, rois_t, gate_t, C_TAKE, C_TAKE, 7, 0.125, ALIGN_S, src=s_t,
                        window=window), 20)
                log(f"{what} ~= plain (rtol {rtol:g}): {N_ROIS} ROIs on one chunk, {n} ROIs on "
                    f"chunks {list(range(0, FEAT[3], C_TAKE))}")
        # least time: read the feature chunks of the copies some ROI reads,
        # rois, gate (and src) once, write the output once; a multiply and an
        # add per nonzero corner term and channel, a gate multiply per output
        live = copies if s_t is None else int(torch.unique(s_t).numel())
        out_elems = B * N_ROIS * 49 * C_TAKE
        in_bytes = (live * FEAT[1] * FEAT[2] * C_TAKE * 2 + rois_t.numel() * 4 + gate_t.numel() * 4
                    + (0 if s_t is None else s_t.numel() * 4))
        terms = align_terms(ra, rois_t, FEAT[1], FEAT[2])
        ops = 2 * terms * C_TAKE + 2 * out_elems
        bound_ms, bound_by = bound(ops, in_bytes, out_elems * 2)
        log(f"{name} bf16 {[copies] + list(FEAT[1:])} x {N_ROIS} ROIs, one 512-channel chunk, "
            f"s={ALIGN_S}: kernel {times['ms']:.3f} ms (windowed {times['window_ms']:.3f} ms), "
            f"plain {times['plain_ms']:.3f} ms (windowed {times['window_plain_ms']:.3f} ms), bound "
            f"{bound_ms:.3f} ms ({bound_by}: {(in_bytes + out_elems * 2) / 1e6:.1f} MB, "
            f"{ops / 1e9:.3f} G operations)")
        records[name] = {"max_abs_err": max_err, "bound_ms": bound_ms, "bound_by": bound_by,
                         **times}
    return records


def phase_align_bwd_kernel(torch, dev, ra):
    """The gated ROIAlign's backward kernel vs its plain version at the
    training shape (res5 ``[4, 100, 152, 2048]`` of B=4 800x1216 images;
    routed by branch at the MRRP training shape ``[12, 100, 152, 2048]``),
    5024 ROIs per image from the box mix with overhanging, degenerate,
    zero-area, invalid and gate-0 rows, bfloat16 and float32, both
    cotangents, one chunk: timed at full N, compared on the first
    ``ALIGN_BWD_PLAIN_N`` ROIs per image. Tolerance as the ROIPool
    backward's: float32 atomics in a varying order, |kernel - plain| <=
    rtol |plain| + 1e-5 max |plain|, rtol 1e-5 or one bfloat16 step; the
    gate cotangent rtol 1e-4."""
    rng = np.random.RandomState(9)
    rois, gate = align_inputs(rng, TB, TW, TH)
    branch = rng.randint(0, N_BRANCH, (TB, N_ROIS))
    branch[:, :N_BRANCH] = np.arange(N_BRANCH)
    src = (branch * TB + np.arange(TB)[:, None]).astype(np.int32)
    rois_t, gate_t, src_t = (torch.from_numpy(a).to(dev) for a in (rois, gate, src))
    g = torch.Generator(device=dev).manual_seed(9)
    base = torch.randn(TRAIN_FEAT_MRRP, generator=g, device=dev)
    n = ALIGN_BWD_PLAIN_N
    max_err, times = 0.0, {}
    for routed in (False, True):
        copies, s_t = (TRAIN_FEAT_MRRP[0], src_t) if routed else (TB, None)
        r_n, g_n = rois_t[:, :n].contiguous(), gate_t[:, :n].contiguous()
        s_n = None if s_t is None else s_t[:, :n].contiguous()
        for dtype, rtol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
            feat = base[:copies].to(dtype).contiguous()
            cot = torch.randn((TB, N_ROIS, 7, 7, C_TAKE), generator=g, device=dev, dtype=dtype)
            what = f"roi_align_gated_bwd{' routed' if routed else ''}, {str(dtype)[6:]}"
            if dtype == torch.bfloat16:  # the training path's call: the feature cotangent only
                times["routed_ms" if routed else "ms"] = cuda_ms(lambda: ra.roi_align_gated_bwd(
                    feat, rois_t, gate_t, None, cot, C_TAKE, C_TAKE, 7, 0.125, ALIGN_S,
                    need_gate=False, src=s_t), 10)
            cot_n = cot[:, :n].contiguous()
            del cot
            out = ra.roi_align_gated(feat, r_n, g_n, C_TAKE, C_TAKE, 7, 0.125, ALIGN_S, src=s_n)
            got_f, got_g = ra.roi_align_gated_bwd(feat, r_n, g_n, out, cot_n, C_TAKE, C_TAKE, 7,
                                                  0.125, ALIGN_S, src=s_n)
            (want_f, _), t = timed(lambda: ra.roi_align_gated_bwd_plain(
                feat, r_n, g_n, None, cot_n, C_TAKE, C_TAKE, 7, 0.125, ALIGN_S, need_gate=False,
                src=s_n, max_elems=1 << 27))
            _, want_g = ra.roi_align_gated_bwd_plain(feat, r_n, g_n, out, cot_n, C_TAKE, C_TAKE, 7,
                                                     0.125, ALIGN_S, need_feat=False, src=s_n)
            if dtype == torch.bfloat16:
                times["routed_plain_ms" if routed else "plain_ms"] = t
                if not routed:
                    times["ms_at_plain_n"] = cuda_ms(lambda: ra.roi_align_gated_bwd(
                        feat, r_n, g_n, None, cot_n, C_TAKE, C_TAKE, 7, 0.125, ALIGN_S,
                        need_gate=False), 10)
            ok, err = near(got_f, want_f, rtol)
            max_err = max(max_err, err)
            if not ok:
                raise AssertionError(f"{what}: g_feat != plain, max |err| {err}")
            if routed and not all(bool(want_f[k].any()) for k in range(copies)):
                raise AssertionError(f"{what}: a copy got no cotangent")
            ok, gerr = near(got_g, want_g, 1e-4, 1e-4)
            if not ok:
                raise AssertionError(f"{what}: g_gate != plain, max |err| {gerr}")
            log(f"{what} ~= plain: {n} ROIs per image, both cotangents (rtol {rtol:g}); plain "
                f"call {t / 1e3:.3f} s")
            del feat, cot_n, out, got_f, got_g, want_f, want_g
            torch.cuda.empty_cache()
    # least time of the training call at full N (unrouted): the function
    # reads the cotangent of the ROIs of nonzero gate only (a gate of 0
    # sends nothing to the feature), rois and gate once, and writes the
    # feature cotangent's chunk once in the feature dtype (the float32
    # scratch is the kernel's own choice); a multiply and an add per nonzero
    # corner term and channel of those ROIs, a gate multiply per cotangent
    # element they read
    h, w = TRAIN_FEAT[1], TRAIN_FEAT[2]
    live = gate_t != 0
    terms = align_terms(ra, rois_t[live], h, w)
    g_elems = int(live.sum()) * 49 * C_TAKE
    chunk_bytes = TB * h * w * C_TAKE * 2
    in_bytes = g_elems * 2 + rois_t.numel() * 4 + gate_t.numel() * 4
    ops = 2 * terms * C_TAKE + g_elems
    bound_ms, bound_by = bound(ops, in_bytes, chunk_bytes)
    log(f"roi_align_gated_bwd bf16 {list(TRAIN_FEAT)} x {N_ROIS} ROIs, one 512-channel chunk, "
        f"feature cotangent: kernel {times['ms']:.3f} ms at {N_ROIS} ROIs per image "
        f"({times['ms_at_plain_n']:.3f} ms at {n}; routed on {list(TRAIN_FEAT_MRRP)} "
        f"{times['routed_ms']:.3f} ms); plain {times['plain_ms']:.3f} ms at {n} (routed "
        f"{times['routed_plain_ms']:.3f} ms); bound {bound_ms:.3f} ms at {N_ROIS} ({bound_by}: "
        f"{(in_bytes + chunk_bytes) / 1e6:.1f} MB, {int(live.sum())} live ROIs, "
        f"{ops / 1e9:.3f} G operations, {terms * C_TAKE // 2 / 1e9:.3f} G float2 atomics)")
    return {"max_abs_err": max_err, "bound_ms": bound_ms, "bound_by": bound_by,
            "n_rois": N_ROIS, "plain_n_rois": n, **times}


class DetectionCounter:
    """Evaluator that counts detections per image and checks they are finite."""

    def __init__(self):
        self.per_image = {}

    def process(self, image_id, boxes, scores, classes):
        if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
            raise AssertionError(f"non-finite detections for image {image_id}")
        if boxes.shape != (len(scores), 4) or classes.shape != scores.shape:
            raise AssertionError(f"bad detection shapes for image {image_id}")
        if len(classes) and not (0 <= classes.min() and classes.max() < 80):
            raise AssertionError(f"class ids out of range for image {image_id}")
        self.per_image[image_id] = len(scores)

    def evaluate(self):
        return dict(self.per_image)


def make_batches(n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        out.append({
            "images": rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
            "image_sizes": np.array([[H, W]] * B, np.int32),
            "sam_boxes": box_mix(rng, B, S),
            "sam_scores": rng.uniform(0.3, 1.0, (B, S)).astype(np.float32),
            "sam_valid": np.ones((B, S), bool),
            "image_id": [f"{i}_{j}" for j in range(B)],
            "orig_size": np.array([[480, 737]] * B, np.int32),
        })
    return out


def stage_times(torch, model, batch, emb, reps=3):
    """Per-stage wall times (ms) of one batch's forward, with a
    ``torch.cuda.synchronize()`` around every stage module call."""
    stages = {"backbone": model.backbone, "rpn": model.proposal_generator,
              "pool": model.roi_heads.pooler, "fc1": model.roi_heads.box_head.fc1}
    acc = {k: 0.0 for k in stages}
    t_in = {}
    handles = []
    for name, mod in stages.items():
        def pre(m, args, name=name):
            torch.cuda.synchronize()
            t_in[name] = time.perf_counter()

        def post(m, args, out, name=name):
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t_in[name]

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    total = 0.0
    try:
        with torch.inference_mode():
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(batch, embeddings=emb)
                torch.cuda.synchronize()
                total += time.perf_counter() - t0
    finally:
        for h in handles:
            h.remove()
    out = {k: 1e3 * v / reps for k, v in acc.items()}
    out["tail"] = 1e3 * total / reps - sum(out.values())
    out["total"] = 1e3 * total / reps
    return out


def profile_batch(torch, model, batch, emb, out_dir, tag):
    """One forward under ``torch.profiler``: device time by kernel and the
    device's busy share of the window; the trace goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with torch.inference_mode():
        model(batch, embeddings=emb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(batch, embeddings=emb)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_trace.json"))
    events = prof.key_averages()
    dev_attr = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    rows = sorted(events, key=lambda e: getattr(e, dev_attr), reverse=True)
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    with open(os.path.join(out_dir, f"{tag}_kernels.txt"), "w") as f:
        f.write(events.table(sort_by=dev_attr, row_limit=60))
    log(f"{tag} profile: wall {wall_ms:.3f} ms, device kernel time {busy_ms:.3f} ms "
        f"(busy share {busy_ms / wall_ms:.3f} if kernels do not overlap)")
    for e in rows[:15]:
        log(f"  {getattr(e, dev_attr) / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}")


def load_cfg(config, pooler=None, align_kernel=None, quant="none"):
    """The config of a slice: TTA off, bf16 compute; the VGG16 YAMLs'
    ``RPN.IN_FEATURES`` set to ``["plain5"]`` (they inherit the base's
    ``res5``, which a VGG16 lacks: ``check_supported`` refuses it by
    name); ``pooler`` sets ``POOLER_TYPE``, ``align_kernel``
    ``TPU.ROI_ALIGN_KERNEL``, ``quant`` both ``TPU.DAN_FC1_QUANT`` and
    ``TPU.RPN_CONV_QUANT``."""
    from wsovod_torch import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(config)
    cfg.TEST.AUG.ENABLED = False
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    if "vgg" in cfg.MODEL.BACKBONE.NAME:
        cfg.MODEL.RPN.IN_FEATURES = ["plain5"]
    if pooler is not None:
        cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE = pooler
    if align_kernel is not None:
        cfg.TPU.ROI_ALIGN_KERNEL = align_kernel
    cfg.TPU.DAN_FC1_QUANT = cfg.TPU.RPN_CONV_QUANT = quant
    return cfg


def pool_kind(model):
    """``(kind, mrrp, n_chunks)`` of a model's pooler: ``"loop"`` (the
    ROILoopPool), ``"align"`` (ROIAlign) or ``"pool"`` (the gated ROIPool),
    with ``"-levels"`` on several pooled levels (the level-routed kernels),
    MRRP or not, and channel chunks per pooled feature."""
    heads = model.roi_heads
    channels = model.backbone.output_channels()[heads.in_features[0]]
    kind = {"ROILoopPool": "loop", "ROIAlign": "align", "ROIAlignV2": "align"}.get(
        heads.pooler.pooler_type, "pool")
    if len(heads.in_features) > 1:
        kind += "-levels"
    return kind, model.mrrp_num_branch > 0, channels // heads.c_take


# the launch counters of each pooler kind's forward and backward kernels
# (module name, attribute), in the wrappers' modules; with the int8 fc1 the
# ROIPool and the ROILoopPool launch their maxabs emission, the align its
# bf16 kernel; on several levels the level-routed modes; the int8 and tile8
# emissions are on no path
FWD_COUNTERS = {"pool": ("rp", "LAUNCHES"), "loop": ("rp", "LOOP_LAUNCHES"),
                "align": ("ra", "LAUNCHES"), "pool-int8": ("rp", "MAXABS_LAUNCHES"),
                "loop-int8": ("rp", "LOOP_MAXABS_LAUNCHES"), "align-int8": ("ra", "LAUNCHES"),
                "pool-levels": ("rp", "LEVEL_LAUNCHES"),
                "loop-levels": ("rp", "LOOP_LEVEL_LAUNCHES")}
BWD_COUNTERS = {"pool": ("rp", "BWD_LAUNCHES"), "loop": ("rp", "LOOP_BWD_LAUNCHES"),
                "align": ("ra", "BWD_LAUNCHES")}
OFF_PATH_COUNTERS = (("rp", "INT8_LAUNCHES"), ("rp", "TILE8_LAUNCHES"),
                     ("rp", "LOOP_INT8_LAUNCHES"), ("ra", "INT8_LAUNCHES"),
                     ("fold", "LAUNCHES"), ("walk", "LAUNCHES"))
ALL_COUNTERS = tuple(dict.fromkeys(tuple(FWD_COUNTERS.values()) + tuple(BWD_COUNTERS.values())
                                   + OFF_PATH_COUNTERS))


def counters_to_zero(mods):
    for mod, attr in ALL_COUNTERS:
        setattr(mods[mod], attr, 0)


def read_counters(mods):
    return {(mod, attr): getattr(mods[mod], attr) for mod, attr in ALL_COUNTERS}


def int8_guard(torch, model, batch, emb, tag):
    """The JAX package's int8-vs-float guard
    (``tests/test_roi_pool_fused.py::test_int8_vs_fp_inference_detections``)
    on one batch of an int8 slice: the ROI heads on the same features,
    proposals and data-aware vector with fc1 int8 and with fc1 in bf16 (the
    model's own parameters with ``quant`` set to ``"none"``: the bf16
    slice's model, which has the same seeded parameters). Pre-NMS class
    probabilities: p99 of |int8 - bf16| / max |bf16| under 3%. Each image's
    top detection: its box within 1 px of the bf16 heads' top box; where it
    is not, the bf16 heads must score the int8 top detection's (proposal,
    class) within twice the largest probability difference of their own top
    score: a near tie, which random weights make common (the 80 class
    probabilities of a ROI are near 1/81), and which NMS then resolves one
    way or the other. Also reports how the int8 RPN conv's proposals
    compare with the bf16 conv's on the same features."""
    heads, fc1 = model.roi_heads, model.roi_heads.box_head.fc1
    conv = model.proposal_generator.rpn_head.conv
    with torch.inference_mode():
        feats = model.backbone(model._normalize(batch["images"]))
        props = model._proposals(feats, batch, None)
        daf = (model._data_aware_features(feats[model.in_feature], batch)
               if model.data_aware_head is not None else None)
        args = (feats, props, batch["image_sizes"])
        det_q, probs_q, _ = heads.inference(*args, data_aware_features=daf, embeddings=emb)
        conv.quant = "none"
        props_f = model._proposals(feats, batch, None)
        fc1.quant = "none"
        try:
            det_f, probs_f, _ = heads.inference(*args, data_aware_features=daf, embeddings=emb)
        finally:
            fc1.quant = conv.quant = "int8"
    pf, pq = probs_f.float(), probs_q.float()
    diff = (pf - pq).abs()
    rel = (diff / pf.abs().max().clamp(min=1e-8)).flatten().cpu().numpy()
    p99 = float(np.percentile(rel, 99))
    tie = 2 * diff.max().item()
    top, gaps, ok = [], [], True
    for i in range(pf.shape[0]):
        s0 = det_f.scores[i][0].float().item()  # the bf16 top score (detections sorted)
        move = (det_f.boxes[i][0] - det_q.boxes[i][0]).abs().max().item()
        # the bf16 score of the int8 top detection's (proposal, class)
        gap = s0 - pf[i, det_q.pred_inds[i][0], det_q.classes[i][0]].item()
        top.append(round(move, 3))
        gaps.append(gap)
        ok &= bool(det_f.valid[i][0] and det_q.valid[i][0]) and (move <= 1.0 or gap <= tie)
    moved = ((props.proposal_boxes - props_f.proposal_boxes).abs().amax(-1) > 1.0) & props.valid
    log(f"{tag} int8 guard: pre-NMS class probabilities p99 |int8 - bf16| / max {p99:.5f} (limit "
        f"0.03), max {rel.max():.5f}; the top detection's box moves {top} px (limit 1, unless a "
        f"near tie: the bf16 heads score the int8 top {[f'{g:.2e}' for g in gaps]} below their "
        f"top, limit {tie:.2e}); the int8 RPN conv moves {int(moved.sum())} of "
        f"{int(props.valid.sum())} proposals by more than 1 px from the bf16 conv's at the same "
        f"rank")
    if not (p99 < 0.03 and ok):
        raise AssertionError(f"{tag}: the int8 heads leave the guard of the bf16 heads: p99 {p99}, "
                             f"top box moves {top} px, score gaps {gaps} (tie {tie})")
    return p99, max(top)


def check_fpn_proposals(torch, model, grids, tag):
    """The RPN's top-k per level and level-aware NMS
    (``find_top_rpn_proposals``) over the slice's five levels on the card
    against the same call on CPU copies of the inputs. The random-weight RPN
    keeps proposals from p3 and p4 only, so the candidates here are the
    slice's anchors at its grids ``grids`` moved by seeded deltas, with
    seeded logits of one distribution on every level: proposals must
    survive from more than two levels, and the two devices must agree
    (validity, levels and logits exactly, boxes to 1e-3 px)."""
    from wsovod_torch.models.proposal_utils import find_top_rpn_proposals
    from wsovod_torch.structures.boxes import apply_deltas

    rpn = model.proposal_generator
    dev = next(model.parameters()).device
    g = torch.Generator().manual_seed(11)
    boxes, logits = [], []
    for anchors in rpn.anchor_generator.grid_anchors(grids, dev):
        deltas = (torch.randn(B, anchors.shape[0], 4, generator=g) * 0.3).to(dev)
        boxes.append(apply_deltas(deltas, anchors[None], weights=rpn.bbox_reg_weights))
        logits.append(torch.randn(B, anchors.shape[0], generator=g).to(dev))
    sizes = torch.tensor([[H, W]] * B, dtype=torch.int32, device=dev)
    args = (rpn.nms_thresh, rpn.pre_nms_topk, rpn.post_nms_topk, rpn.min_box_size)
    find_top_rpn_proposals(boxes, logits, sizes, *args)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = find_top_rpn_proposals(boxes, logits, sizes, *args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = find_top_rpn_proposals([x.cpu() for x in boxes], [x.cpu() for x in logits],
                                  sizes.cpu(), *args)
    valid = got.valid.cpu()
    kept = torch.bincount(got.level_ids.cpu()[valid].flatten(), minlength=len(grids)).tolist()
    box_err = (got.proposal_boxes.cpu() - want.proposal_boxes).abs().max().item()
    if not (torch.equal(valid, want.valid) and torch.equal(got.level_ids.cpu(), want.level_ids)
            and torch.equal(got.objectness_logits.cpu(), want.objectness_logits)
            and box_err <= 1e-3):
        raise AssertionError(f"{tag}: the card's five-level proposals differ from the CPU's "
                             f"(box err {box_err})")
    if sum(k > 0 for k in kept) <= 2:
        raise AssertionError(f"{tag}: seeded proposals survive on levels {kept} only")
    log(f"{tag} five-level proposals (seeded logits, grids {grids}): card == CPU, kept per "
        f"level {dict(zip(rpn.in_features, kept))} ({int(valid.sum())} valid), box err "
        f"{box_err:.3g}, {ms:.3f} ms on the card")


def run_slice(torch, dev, mods, tag, config, emb, pooler=None, align_kernel=None, quant="none",
              bf16_stages=None):
    """Drive one slice through ``inference_on_dataset`` and check it (see
    the module docstring); returns the slice kernel's launch count, the
    largest difference of a model chunk from the plain version and the
    stage times. ``quant`` "int8": the int8 slice, its int8 GEMMs counted,
    its guard against the bf16 heads checked and its stage times printed
    beside ``bf16_stages``."""
    from wsovod_torch.engine.evaluator import inference_on_dataset
    from wsovod_torch.models import build_model
    from wsovod_torch.models import layers

    rp, ra = mods["rp"], mods["ra"]
    int8 = quant == "int8"
    cfg = load_cfg(config, pooler, align_kernel, quant)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    kind, mrrp, n_chunks = pool_kind(model)
    counter = FWD_COUNTERS[f"{kind}-int8" if int8 else kind]
    maxabs = model.roi_heads.pooler.emits_maxabs(int8)
    rpn = model.proposal_generator
    levels = model.mrrp_num_branch if mrrp and rpn.mrrp_test_all else 1
    window = getattr(model.roi_heads.pooler, "window", None)
    log(f"{tag} model: {os.path.basename(config)}, {cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE}"
        f"{f' (windowed, {window})' if window else ''}"
        f"{f', fc1 and RPN conv int8, {n_chunks} chunks' if int8 else ''}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f}M parameters, built in "
        f"{time.perf_counter() - t0:.3f} s")
    warm = make_batches(1, seed=7)
    batches = make_batches(N_BATCHES)
    inference_on_dataset(model, warm, DetectionCounter(), embeddings=emb)  # warm-up
    torch.cuda.synchronize()

    captured, rpn_out, feat_std, feat_shape, grids = [], [], [], [], []

    def capture(mod, inp, out):
        if len(captured) < n_chunks:  # the first batch's chunks
            captured.append((inp, out))

    def capture_rpn(mod, inp, out):
        if not rpn_out:
            rpn_out.append(out)
            grids.extend(tuple(inp[0][k].shape[1:3]) for k in mod.in_features)
            f = inp[0][mod.in_features[0]].float()
            feat_std.extend(f.flatten(1).std(dim=1).tolist())
            feat_shape.extend(f.shape)

    hooks = [model.roi_heads.pooler.register_forward_hook(capture),
             model.proposal_generator.register_forward_hook(capture_rpn)]
    torch.cuda.reset_peak_memory_stats(dev)
    counters_to_zero(mods)
    layers.INT_MM_CALLS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = inference_on_dataset(model, batches, DetectionCounter(), embeddings=emb)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = read_counters(mods)
    launches = launched.pop(counter)
    int_mms = layers.INT_MM_CALLS
    for h in hooks:
        h.remove()
    n_images = B * N_BATCHES
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    if launches != n_chunks * N_BATCHES or any(launched.values()):
        raise AssertionError(f"{tag}: {counter} {launches} (expected {n_chunks * N_BATCHES}), "
                             f"the others {launched} (expected 0)")
    want_mms = N_BATCHES * (n_chunks + 9 * levels) if int8 else 0  # fc1 chunks, 9 per conv
    if int_mms != want_mms:
        raise AssertionError(f"{tag}: {int_mms} int8 GEMMs, expected {want_mms}")
    if len(counts) != n_images or min(counts.values()) <= 0:
        raise AssertionError(f"{tag}: images without detections: {counts}")
    if len(captured) != n_chunks:
        raise AssertionError(f"{tag}: captured {len(captured)} pooled chunks")
    max_err, per_level = 0.0, None
    for k, ((feat, boxes, gate, c_base, c_take, src, rows, emit, level), out) in enumerate(
            captured):
        assert rows == 1 and emit == maxabs, (rows, emit)
        assert (level is not None) == kind.endswith("-levels"), kind
        out, m = out if maxabs else (out, None)
        channels = (feat[0] if level is not None else feat).shape[3]
        assert out.shape == (B, N_ROIS, 7, 7, c_take) and c_take * n_chunks == channels, (
            out.shape, n_chunks)
        if int8:  # the int8 slices' chunks on their first REDUCED_N ROIs per image
            cut = slice(0, REDUCED_N)
            out, m = out[:, cut], (None if m is None else m[:, cut])
            boxes, gate = boxes[:, cut].contiguous(), gate[:, cut].contiguous()
            src = None if src is None else src[:, cut].contiguous()
        if level is not None:  # each ROI on its own FPN level
            scales = model.roi_heads.pooler.scales
            per_level = torch.bincount(level.flatten(), minlength=len(scales)).tolist()
            if len(set(level.flatten().tolist())) < 2:
                raise AssertionError(f"{tag}: the ROIs fall on one level only: {per_level}")
            if kind == "loop-levels":
                want = rp.roi_loop_pool_levels_plain(feat, boxes, gate, level, c_base, c_take, 1,
                                                     7, scales, 1.8, max_elems=1 << 28)[0]
            else:
                want = rp.roi_pool_levels_plain(feat, boxes, gate, level, c_base, c_take, 7,
                                                scales, max_elems=1 << 28)
        elif kind == "loop":
            assert feat.shape[0] == (N_BRANCH * B if mrrp else B), feat.shape
            want = rp.roi_loop_pool_gated_plain(feat, boxes, gate, src, c_base, c_take, 1, 7, 0.125,
                                                1.8, max_elems=1 << 28)[0]
        elif kind == "align":
            assert feat.shape[0] == (N_BRANCH * B if mrrp else B), feat.shape
            assert (src is not None) == mrrp  # routed by branch under MRRP only
            want = ra.roi_align_gated_plain(feat, boxes, gate, c_base, c_take, 7, 0.125, ALIGN_S,
                                            src=src, window=window, max_elems=1 << 27)
        else:
            assert feat.shape[0] == (N_BRANCH * B if mrrp else B), feat.shape
            assert (src is not None) == mrrp  # routed by branch under MRRP only
            want = rp.roi_pool_gated_plain(feat, boxes, gate, c_base, c_take, 7, 0.125,
                                           max_elems=1 << 28, src=src)
        max_err = max(max_err, (out.float() - want.float()).abs().max().item())
        if kind == "align":  # float32 sums in another order, one bf16 rounding
            if not near(out, want, 2.0 ** -7)[0]:
                raise AssertionError(f"{tag}: model chunk {k} differs from the plain align")
        elif not torch.equal(out, want):
            raise AssertionError(f"{tag}: model chunk {k} differs from the plain pool")
        if maxabs and not torch.equal(m, want.float().abs().amax(dim=(2, 3, 4))):
            raise AssertionError(f"{tag}: model chunk {k}'s maxabs differs from the plain pool's")
    rpn = rpn_out[0]
    branches = torch.unique(torch.div(rpn.level_ids[rpn.valid], 1000, rounding_mode="floor")).tolist()
    if mrrp and len(branches) < 2:
        raise AssertionError(f"{tag}: RPN proposals from branches {branches} only")
    if per_level is not None:
        rpn_levels = torch.bincount(rpn.level_ids[rpn.valid].flatten(),
                                    minlength=len(model.proposal_generator.in_features)).tolist()
        log(f"{tag} levels: the first batch's ROIs per pooled level "
            f"{dict(zip(model.roi_heads.in_features, per_level))}; RPN proposals per level "
            f"{dict(zip(model.proposal_generator.in_features, rpn_levels))}")
        check_fpn_proposals(torch, model, grids, tag)
    log(f"{tag} slice: {n_images} images in {dt:.3f} s = {n_images / dt:.3f} images/s (B={B}, "
        f"{H}x{W}, {N_ROIS} ROIs/image, bf16{', int8 fc1 and RPN conv' if int8 else ''}); "
        f"detections/image min {min(counts.values())} max {max(counts.values())}; "
        f"{'.'.join(counter)} {launches}; int8 GEMMs {int_mms}; first batch's {len(captured)} "
        f"pooled chunks{' and maxabs' if maxabs else ''} == plain"
        f"{f' on their first {REDUCED_N} ROIs per image' if int8 else ''} (max |err| "
        f"{max_err:.3g}); RPN "
        f"proposals from branches {branches} ({int(rpn.valid.sum())} valid of "
        f"{rpn.valid.numel()}); the RPN's input feature {feat_shape}, std per "
        f"copy {[round(v, 3) for v in feat_std]}; peak memory {peak_gb:.3f} GB")
    batch0 = {k: torch.as_tensor(batches[0][k]).to(dev)
              for k in ("images", "image_sizes", "sam_boxes", "sam_scores", "sam_valid")}
    st = stage_times(torch, model, batch0, emb)
    log(f"{tag} stages (ms per B=2 batch, synchronised): "
        + json.dumps({k: round(v, 3) for k, v in st.items()}))
    if int8:
        int8_guard(torch, model, batch0, emb, tag)
        log(f"{tag} vs the bf16 slice, ms per batch: fc1 {st['fc1']:.3f} vs "
            f"{bf16_stages['fc1']:.3f}, rpn {st['rpn']:.3f} vs {bf16_stages['rpn']:.3f}, total "
            f"{st['total']:.3f} vs {bf16_stages['total']:.3f}")
    profile_batch(torch, model, batch0, emb, PROFILE_DIR, tag)
    del model
    torch.cuda.empty_cache()
    return launches, max_err, st


def phase_bwd_kernel(torch, dev, rp):
    """The gated ROIPool's backward kernel vs plain at the training shape.
    Tolerance: the kernel adds the feature cotangent with float32 atomics
    in a varying order, so |kernel - plain| <= rtol |plain| + 1e-5 max
    |plain| with rtol 1e-5 (float32) or one bfloat16 step, 2**-7; the gate
    cotangent (a block sum in another order) rtol 1e-4."""
    rois, gate = pool_inputs(np.random.RandomState(2), TB, TW, TH)
    rois_t, gate_t = torch.from_numpy(rois).to(dev), torch.from_numpy(gate).to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    base = torch.round(torch.relu(torch.randn(TRAIN_FEAT, generator=g, device=dev)) * 4) / 4
    cot = torch.randn((TB, N_ROIS, 7, 7, C_TAKE), generator=g, device=dev)
    n = REDUCED_N
    max_err, times = 0.0, {}

    def check(feat, cot_, rois_, gate_, c_base, rtol, what, timed_plain=False):
        nonlocal max_err
        out = rp.roi_pool_gated(feat, rois_, gate_, c_base, C_TAKE, 7, 0.125)
        got_f, got_g = rp.roi_pool_gated_bwd(feat, rois_, gate_, out, cot_, c_base, C_TAKE, 7, 0.125)
        (want_f, _), t = timed(lambda: rp.roi_pool_gated_bwd_plain(
            feat, rois_, gate_, None, cot_, c_base, C_TAKE, 7, 0.125, need_gate=False,
            max_elems=1 << 28))
        _, want_g = rp.roi_pool_gated_bwd_plain(feat, rois_, gate_, out, cot_, c_base, C_TAKE, 7,
                                                0.125, need_feat=False)
        ok, err = near(got_f, want_f, rtol)
        max_err = max(max_err, err)
        if not ok:
            raise AssertionError(f"roi_pool_gated_bwd g_feat != plain ({what}): max |err| {err}")
        ok, gerr = near(got_g, want_g, 1e-4, 1e-4)
        if not ok:
            raise AssertionError(f"roi_pool_gated_bwd g_gate != plain ({what}): max |err| {gerr}")
        if timed_plain:
            times["plain_ms"] = t

    for dtype, rtol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
        feat, cot_d = base.to(dtype).contiguous(), cot.to(dtype)
        name = str(dtype)[6:]
        check(feat, cot_d, rois_t, gate_t, C_TAKE, rtol, f"{name}, full N",
              timed_plain=dtype == torch.bfloat16)
        for c_base in range(0, TRAIN_FEAT[3], C_TAKE):
            check(feat, cot_d[:, :n].contiguous(), rois_t[:, :n].contiguous(),
                  gate_t[:, :n].contiguous(), c_base, rtol, f"{name}, {n} ROIs, c_base {c_base}")
        if dtype == torch.bfloat16:  # the training path's call: the feature cotangent only
            times["ms"] = cuda_ms(lambda: rp.roi_pool_gated_bwd(
                feat, rois_t, gate_t, None, cot_d, C_TAKE, C_TAKE, 7, 0.125, need_gate=False), 10)
        log(f"roi_pool_gated_bwd ~= plain, {name}: {N_ROIS} ROIs on one chunk, {n} ROIs on chunks "
            f"{list(range(0, TRAIN_FEAT[3], C_TAKE))}, both cotangents (rtol {rtol:g})")
    # least time of the training call: read g, the feature chunk, rois and
    # gate once, write the float32 scratch once; a max and a tie test per bin
    # pixel and channel
    region = rp.round_region(rois_t, 0.125)
    pixels = int(bin_pixels(rp, region, None, 7, TRAIN_FEAT[1], TRAIN_FEAT[2]).sum()) * C_TAKE
    out_elems = TB * N_ROIS * 49 * C_TAKE
    chunk_elems = TB * TRAIN_FEAT[1] * TRAIN_FEAT[2] * C_TAKE
    in_bytes = out_elems * 2 + chunk_elems * 2 + rois_t.numel() * 4 + gate_t.numel() * 4
    bound_ms, bound_by = bound(2 * pixels + out_elems, in_bytes, chunk_elems * 4)
    log(f"roi_pool_gated_bwd bf16 {list(TRAIN_FEAT)} x {N_ROIS} ROIs, one 512-channel chunk, "
        f"feature cotangent: kernel {times['ms']:.3f} ms, plain {times['plain_ms']:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: {(in_bytes + chunk_elems * 4) / 1e6:.1f} MB, "
        f"{2 * pixels / 1e9:.3f} G compares)")
    return {"max_abs_err": max_err, "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_loop_bwd_kernel(torch, dev, rp):
    """The ROILoopPool's backward kernel vs plain at the MRRP training shape:
    res5's three branch copies ``[12, 100, 152, 2048]`` (a post-ReLU map on a
    0.25 grid, so bins tie, many at 0), 5024 ROIs per image from the box mix
    routed to random branches, with overhanging, degenerate, 2-pixel (empty
    holes), invalid and gate-0 rows; bfloat16 and float32, both cotangents,
    one 512-channel chunk. The kernel is timed at full N (and with the ROI
    row alone and with the frame, where the time goes), and meets its plain
    version on the first ``LOOP_BWD_PLAIN_N`` ROIs per image (the plain
    version at full N would take minutes). Then the same map with dead
    areas (``dead_rects``: whole sets tie at 0), and the single-copy call
    (``src`` the image, ``[4, 100, 152, 2048]``): each timed at full N and
    held against the plain version on the first ``LOOP_BWD_DEAD_N`` ROIs per
    image. Tolerance as the ROIPool backward's: the kernel adds the feature
    cotangent with float32 atomics in a varying order, so |kernel - plain| <=
    rtol |plain| + 1e-5 max |plain| with rtol 1e-5 (float32) or one bfloat16
    step, 2**-7; the gate cotangent rtol 1e-4."""
    rng = np.random.RandomState(4)
    rois, gate = pool_inputs(rng, TB, TW, TH)
    rois[:, 5] = [300, 300, 310, 310]  # 2 px at stride 8: both holes empty
    rois[:, 6] = [100, 100, 500, 400]
    gate[:, 6] = 0.0  # a valid box with gate 0
    branch = rng.randint(0, N_BRANCH, (TB, N_ROIS))
    branch[:, :N_BRANCH] = np.arange(N_BRANCH)
    src = (branch * TB + np.arange(TB)[:, None]).astype(np.int32)
    rois_t, gate_t, src_t = (torch.from_numpy(a).to(dev) for a in (rois, gate, src))
    image_t = torch.arange(TB, dtype=torch.int32, device=dev)[:, None].expand(TB, N_ROIS)
    image_t = image_t.contiguous()
    g = torch.Generator(device=dev).manual_seed(4)
    base = torch.round(torch.relu(torch.randn(TRAIN_FEAT_MRRP, generator=g, device=dev)) * 4) / 4
    dead = dead_rects(torch, base, 13)
    n, n_dead = LOOP_BWD_PLAIN_N, LOOP_BWD_DEAD_N
    max_err, times = 0.0, {}

    def check(feat, cot, src_, k, rtol, what):
        """The kernel against its plain version on the first ``k`` ROIs per
        image; returns the plain call's ms."""
        nonlocal max_err
        r_k, g_k, s_k = (t[:, :k].contiguous() for t in (rois_t, gate_t, src_))
        cot_k = cot[:, :, :k].contiguous()
        out = rp.roi_loop_pool_gated(feat, r_k, g_k, s_k, C_TAKE, C_TAKE, 3, 7, 0.125)
        got_f, got_g = rp.roi_loop_pool_gated_bwd(feat, r_k, g_k, s_k, out, cot_k, C_TAKE, C_TAKE,
                                                  7, 0.125)
        (want_f, _), t = timed(lambda: rp.roi_loop_pool_gated_bwd_plain(
            feat, r_k, g_k, s_k, None, cot_k, C_TAKE, C_TAKE, 7, 0.125, need_gate=False,
            max_elems=1 << 28))
        _, want_g = rp.roi_loop_pool_gated_bwd_plain(feat, r_k, g_k, s_k, out, cot_k, C_TAKE,
                                                     C_TAKE, 7, 0.125, need_feat=False)
        ok, err = near(got_f, want_f, rtol)
        max_err = max(max_err, err)
        if not ok:
            raise AssertionError(f"roi_loop_pool_gated_bwd g_feat != plain ({what}): max "
                                 f"|err| {err}")
        ok, gerr = near(got_g, want_g, 1e-4, 1e-4)
        if not ok:
            raise AssertionError(f"roi_loop_pool_gated_bwd g_gate != plain ({what}): max "
                                 f"|err| {gerr}")
        log(f"roi_loop_pool_gated_bwd ~= plain, {what}: {k} ROIs per image on one chunk, both "
            f"cotangents (rtol {rtol:g}); plain call {t / 1e3:.3f} s")
        return t

    def call(feat, cot, src_):  # the training path's call: the feature cotangent only
        return lambda: rp.roi_loop_pool_gated_bwd(feat, rois_t, gate_t, src_, None, cot, C_TAKE,
                                                  C_TAKE, 7, 0.125, need_gate=False)

    for dtype, rtol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
        feat = base.to(dtype).contiguous()
        feat_dead = dead.to(dtype).contiguous()
        one_copy = feat[:TB]  # src = the image: _pool_ad_bwd's call
        cot = torch.randn((3, TB, N_ROIS, 7, 7, C_TAKE), generator=g, device=dev, dtype=dtype)
        name = str(dtype)[6:]
        if dtype == torch.bfloat16:
            times["ms"] = cuda_ms(call(feat, cot, src_t), 5)
            for rows in (1, 2):  # where the time goes: the ROI row, then with the frame
                times[f"ms_rows{rows}"] = cuda_ms(call(feat, cot[:rows].contiguous(), src_t), 3)
            times["dead_ms"] = cuda_ms(call(feat_dead, cot, src_t), 5)
            times["single_copy_ms"] = cuda_ms(call(one_copy, cot, image_t), 5)
            times["ms_at_plain_n"] = cuda_ms(lambda: rp.roi_loop_pool_gated_bwd(
                feat, *(t[:, :n].contiguous() for t in (rois_t, gate_t, src_t)), None,
                cot[:, :, :n].contiguous(), C_TAKE, C_TAKE, 7, 0.125, need_gate=False), 5)
        t = check(feat, cot, src_t, n, rtol, f"{name}, routed")
        if dtype == torch.bfloat16:
            times["plain_ms"] = t
        check(feat_dead, cot, src_t, n_dead, rtol, f"{name}, routed, dead areas")
        check(one_copy, cot, image_t, n_dead, rtol, f"{name}, single copy")
        del feat, feat_dead, one_copy, cot
        torch.cuda.empty_cache()
    bound_ms, bound_by, nbytes, ops = loop_bwd_bound(torch, rp, rois_t, gate_t, src_t)
    one_bound, one_by, _, _ = loop_bwd_bound(torch, rp, rois_t, gate_t, image_t)
    log(f"roi_loop_pool_gated_bwd bf16 {list(TRAIN_FEAT_MRRP)} x {N_ROIS} ROIs, one 512-channel "
        f"chunk, feature cotangent: kernel {times['ms']:.3f} ms at {N_ROIS} ROIs per image "
        f"(the ROI row alone {times['ms_rows1']:.3f} ms, with the frame {times['ms_rows2']:.3f} "
        f"ms; dead areas {times['dead_ms']:.3f} ms), {times['ms_at_plain_n']:.3f} ms at {n}; "
        f"plain {times['plain_ms']:.3f} ms at {n}; bound {bound_ms:.3f} ms at {N_ROIS} "
        f"({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G operations); single copy "
        f"{[TB] + list(TRAIN_FEAT_MRRP[1:])}: kernel "
        f"{times['single_copy_ms']:.3f} ms, bound {one_bound:.3f} ms ({one_by})")
    return {"max_abs_err": max_err, "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "n_rois": N_ROIS, "plain_n_rois": n,
            "ms_at_plain_n": times["ms_at_plain_n"], "ms_rows1": times["ms_rows1"],
            "ms_rows2": times["ms_rows2"], "dead_ms": times["dead_ms"],
            "single_copy_ms": times["single_copy_ms"], "single_copy_bound_ms": one_bound}


def loop_bwd_bound(torch, rp, rois_t, gate_t, src_t):
    """``(bound_ms, bound_by, bytes, operations)`` of one loop-backward
    chunk call at the training shape, feature cotangent only: read the
    three-row cotangent, the feature chunks of the copies some ROI reads,
    boxes, gates and sources once, write the float32 scratch of those
    copies once; a max and a tie test per visited pixel and channel (the
    ROI's bins, both masked sets of the frame's and the context's) for the
    ROIs of nonzero gate, and a gate multiply per cotangent element."""
    h, w = TRAIN_FEAT_MRRP[1], TRAIN_FEAT_MRRP[2]
    geo = rp.loop_geometry(rois_t, 0.125, h, w, 1.8)
    live = (gate_t != 0)[..., None, None]
    pixels = sum(int((c * live).sum()) for c in (
        bin_pixels(rp, geo[..., 0:4], None, 7, h, w),
        hollow_set_pixels(rp, geo[..., 0:4], geo[..., 8:12], 7, h, w),
        hollow_set_pixels(rp, geo[..., 4:8], geo[..., 12:16], 7, h, w))) * C_TAKE
    copies = int(torch.unique(src_t).numel())
    g_elems = 3 * TB * N_ROIS * 49 * C_TAKE
    chunk_elems = copies * h * w * C_TAKE
    in_bytes = g_elems * 2 + chunk_elems * 2 + rois_t.numel() * 4 + 2 * gate_t.numel() * 4
    bound_ms, bound_by = bound(2 * pixels + g_elems, in_bytes, chunk_elems * 4)
    return bound_ms, bound_by, in_bytes + chunk_elems * 4, 2 * pixels + g_elems


def phase_routed_bwd_kernel(torch, dev, rp):
    """The gated ROIPool's backward routed by branch vs its plain version at
    the MRRP VGG16 training shape: plain5's three branch copies ``[12, 99,
    151, 512]`` (a post-ReLU map on a 0.25 grid, so bins tie, many at 0),
    5024 ROIs per image from the box mix routed to random branches, with
    overhanging, degenerate, invalid and gate-0 rows; bfloat16 and float32,
    both cotangents. Timed at full N, compared on the first
    ``LOOP_BWD_PLAIN_N`` ROIs per image, to the ROIPool backward's tolerance
    (float32 atomics: rtol 1e-5 or one bfloat16 step, plus 1e-5 max
    |plain|; the gate cotangent rtol 1e-4)."""
    rng = np.random.RandomState(6)
    rois, gate, src = routed_inputs(rng, TB, TW, TH)
    rois[:, 6] = [100, 100, 500, 400]
    gate[:, 6] = 0.0  # a valid box with gate 0
    rois_t, gate_t, src_t = (torch.from_numpy(a).to(dev) for a in (rois, gate, src))
    g = torch.Generator(device=dev).manual_seed(6)
    shape = (N_BRANCH * TB,) + VGG_TRAIN_FEAT[1:]
    base = torch.round(torch.relu(torch.randn(shape, generator=g, device=dev)) * 4) / 4
    n = LOOP_BWD_PLAIN_N
    r_n, g_n, s_n = (t[:, :n].contiguous() for t in (rois_t, gate_t, src_t))
    max_err, times = 0.0, {}
    for dtype, rtol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
        feat = base.to(dtype).contiguous()
        cot = torch.randn((TB, N_ROIS, 7, 7, C_TAKE), generator=g, device=dev, dtype=dtype)
        name = str(dtype)[6:]
        if dtype == torch.bfloat16:  # the training path's call: the feature cotangent only
            times["ms"] = cuda_ms(lambda: rp.roi_pool_gated_bwd(
                feat, rois_t, gate_t, None, cot, 0, C_TAKE, 7, 0.125, need_gate=False,
                src=src_t), 10)
        cot_n = cot[:, :n].contiguous()
        del cot
        out = rp.roi_pool_gated(feat, r_n, g_n, 0, C_TAKE, 7, 0.125, s_n)
        got_f, got_g = rp.roi_pool_gated_bwd(feat, r_n, g_n, out, cot_n, 0, C_TAKE, 7, 0.125,
                                             src=s_n)
        if dtype == torch.bfloat16:
            times["ms_at_plain_n"] = cuda_ms(lambda: rp.roi_pool_gated_bwd(
                feat, r_n, g_n, None, cot_n, 0, C_TAKE, 7, 0.125, need_gate=False, src=s_n), 10)
        (want_f, _), t = timed(lambda: rp.roi_pool_gated_bwd_plain(
            feat, r_n, g_n, None, cot_n, 0, C_TAKE, 7, 0.125, need_gate=False,
            max_elems=1 << 28, src=s_n))
        _, want_g = rp.roi_pool_gated_bwd_plain(feat, r_n, g_n, out, cot_n, 0, C_TAKE, 7, 0.125,
                                                need_feat=False, src=s_n)
        if dtype == torch.bfloat16:
            times["plain_ms"] = t
        ok, err = near(got_f, want_f, rtol)
        max_err = max(max_err, err)
        if not ok:
            raise AssertionError(f"routed roi_pool_gated_bwd g_feat != plain ({name}): max "
                                 f"|err| {err}")
        if not all(bool(want_f[k].any()) for k in range(shape[0])):
            raise AssertionError(f"routed roi_pool_gated_bwd: a copy got no cotangent ({name})")
        ok, gerr = near(got_g, want_g, 1e-4, 1e-4)
        if not ok:
            raise AssertionError(f"routed roi_pool_gated_bwd g_gate != plain ({name}): max "
                                 f"|err| {gerr}")
        log(f"roi_pool_gated_bwd routed ~= plain, {name}: {n} ROIs per image, both cotangents "
            f"(rtol {rtol:g}); plain call {t / 1e3:.3f} s")
        del feat, cot_n, out, got_f, got_g, want_f, want_g, err
        torch.cuda.empty_cache()
    # least time of the training call at full N: read g, the chunks of the
    # copies some ROI reads, rois, gates and sources once, write their float32
    # scratch once; a max and a tie test per bin pixel and channel of the ROIs
    # of nonzero gate, a gate multiply per cotangent element
    h, w = VGG_TRAIN_FEAT[1], VGG_TRAIN_FEAT[2]
    live = (gate_t != 0)[..., None, None]
    pixels = int((bin_pixels(rp, rp.round_region(rois_t, 0.125), None, 7, h, w) * live).sum())
    pixels *= C_TAKE
    copies = int(torch.unique(src_t).numel())
    g_elems = TB * N_ROIS * 49 * C_TAKE
    chunk_elems = copies * h * w * C_TAKE
    in_bytes = (g_elems * 2 + chunk_elems * 2 + rois_t.numel() * 4 + 2 * gate_t.numel() * 4
                + src_t.numel() * 4)
    bound_ms, bound_by = bound(2 * pixels + g_elems, in_bytes, chunk_elems * 4)
    log(f"roi_pool_gated_bwd routed bf16 {list(shape)} x {N_ROIS} ROIs, one 512-channel chunk, "
        f"feature cotangent: kernel {times['ms']:.3f} ms at {N_ROIS} ROIs per image, "
        f"{times['ms_at_plain_n']:.3f} ms at {n}; plain {times['plain_ms']:.3f} ms at {n}; bound "
        f"{bound_ms:.3f} ms at {N_ROIS} ({bound_by}: {(in_bytes + chunk_elems * 4) / 1e6:.1f} MB, "
        f"{(2 * pixels + g_elems) / 1e9:.3f} G operations)")
    return {"max_abs_err": max_err, "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "n_rois": N_ROIS, "plain_n_rois": n,
            "ms_at_plain_n": times["ms_at_plain_n"]}


def train_batches(n, seed):
    """``n`` synthetic training batches: B=4 800x1216 images, 4000 SAM
    proposals each, 1-4 distinct image-level classes of 80 per image."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        classes = np.stack([rng.choice(80, 4, replace=False) for _ in range(TB)]).astype(np.int32)
        out.append({
            "images": rng.uniform(0, 255, (TB, TH, TW, 3)).astype(np.float32),
            "image_sizes": np.array([[TH, TW]] * TB, np.int32),
            "sam_boxes": box_mix(rng, TB, S, TW, TH),
            "sam_scores": rng.uniform(0.3, 1.0, (TB, S)).astype(np.float32),
            "sam_valid": np.ones((TB, S), bool),
            "gt_classes": classes,
            "gt_valid": np.arange(4)[None, :] < rng.randint(1, 5, (TB, 1)),
        })
    return out


LOSSES = ("loss_cls_object_mining", "loss_cls_r0", "loss_box_reg_r0", "loss_rpn_cls",
          "loss_rpn_loc")


def train_split(torch, trainer, batches, emb, tag):
    """Per-phase times of one update's worth of iterations (synchronised
    between phases), then one forward split by stage with synchronising
    hooks, then one profiled iteration (trace and kernel table to
    ``profiles/``); returns the numbers."""
    step = trainer.step
    fwd, bwd, opt = [], [], []
    for batch in batches[:step.iter_size]:
        b = trainer.device_batch(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step.forward(b, emb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step.backward(losses)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        step.update()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        fwd.append(t1 - t0)
        bwd.append(t2 - t1)
        opt.append(t3 - t2)
        if not all(math.isfinite(losses[k].item()) for k in LOSSES):
            raise AssertionError(f"non-finite losses {losses}")
    model = trainer.model
    stages = {"backbone": model.backbone, "rpn": model.proposal_generator,
              "pool": model.roi_heads.pooler, "fc1": model.roi_heads.box_head.fc1}
    acc, t_in, handles = {k: 0.0 for k in stages}, {}, []
    for name, mod in stages.items():
        def pre(m, args, name=name):
            torch.cuda.synchronize()
            t_in[name] = time.perf_counter()

        def post(m, args, out, name=name):
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t_in[name]

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    b = trainer.device_batch(batches[0])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step.forward(b, emb)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for h in handles:
            h.remove()
    del losses
    sub = {"backbone": acc["backbone"], "rpn": acc["rpn"], "pool+fc1": acc["pool"] + acc["fc1"]}
    sub["heads+mining+losses"] = total - sum(sub.values())

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.backward(step.forward(b, emb))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    step.optimizer.zero_grad(set_to_none=True)  # the profiled iteration's gradients are dropped
    events = prof.key_averages()
    dev_attr = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    os.makedirs(PROFILE_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(PROFILE_DIR, f"{tag}_trace.json"))
    with open(os.path.join(PROFILE_DIR, f"{tag}_kernels.txt"), "w") as f:
        f.write(events.table(sort_by=dev_attr, row_limit=60))
    for e in sorted(events, key=lambda e: getattr(e, dev_attr), reverse=True)[:12]:
        log(f"  {getattr(e, dev_attr) / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}")
    ms = lambda xs: 1e3 * sum(xs) / len(xs)
    return {"forward_ms": ms(fwd), "backward_ms": ms(bwd), "optimizer_ms_per_update": 1e3 * max(opt),
            "ms_per_iteration": ms([a + b_ + c for a, b_, c in zip(fwd, bwd, opt)]),
            "forward_split_ms": {k: 1e3 * v for k, v in sub.items()},
            "profiled_iteration_ms": wall_ms, "profiled_device_ms": busy_ms,
            "busy_share": busy_ms / wall_ms}


def run_train(torch, dev, mods, tag, config, freeze_at, iters, emb, resume_check, pooler=None):
    """Drive ``WSOVODTrainer.train()`` on ``config`` for ``iters``
    iterations and check it (see the module docstring); returns ``(pool
    launches, backward launches)`` of the config's pooler."""
    from wsovod_torch.engine.trainer import WSOVODTrainer

    cfg = load_cfg(config, pooler)
    cfg.MODEL.WEIGHTS = ""  # seeded random weights
    cfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
    cfg.SOLVER.MAX_ITER = iters
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.SEED = 0
    out_dir = os.path.join(PROFILE_DIR, f"{tag}_output")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg.OUTPUT_DIR = out_dir
    batches = train_batches(iters, seed=3)
    t0 = time.perf_counter()
    trainer = WSOVODTrainer(cfg, iter(batches), embeddings=emb, device=dev)
    tc = trainer.cfg
    # the recipe's 4 workers on one card: ITER_SIZE x4, BASE_LR / 4
    if (tc.WSOVOD.ITER_SIZE, tc.SOLVER.BASE_LR, tc.WSOVOD.BBOX_REFINE.ENABLE) != (
            4, cfg.SOLVER.BASE_LR / 4, False):
        raise AssertionError(f"{tag}: ITER_SIZE {tc.WSOVOD.ITER_SIZE}, BASE_LR {tc.SOLVER.BASE_LR}, "
                             f"BBOX_REFINE {tc.WSOVOD.BBOX_REFINE.ENABLE}")
    model = trainer.model
    log(f"{tag} trainer: {os.path.basename(config)}, FREEZE_AT {freeze_at}, "
        f"{sum(p.numel() for p in model.parameters() if p.requires_grad) / 1e6:.3f}M trainable of "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f}M parameters, built in "
        f"{time.perf_counter() - t0:.3f} s")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    kind, mrrp, n_chunks = pool_kind(model)
    loop = kind == "loop"
    vgg = "vgg" in cfg.MODEL.BACKBONE.NAME
    counters = (FWD_COUNTERS[kind], BWD_COUNTERS[kind])
    rows, branches, captured = [], set(), []

    def pooled(mod, inp, out):
        rows.append(out.shape[0] if out.dim() == 6 else 1)

    def proposed(mod, inp, out):
        props = out[0]
        branches.update(torch.div(props.level_ids[props.valid], 1000,
                                  rounding_mode="floor").unique().tolist())

    bwd_mod = mods["ra" if kind == "align" else "rp"]
    bwd_name = {"loop": "roi_loop_pool_gated_bwd", "align": "roi_align_gated_bwd"}.get(
        kind, "roi_pool_gated_bwd")
    kernel_bwd, plain_bwd = getattr(bwd_mod, bwd_name), getattr(bwd_mod, bwd_name + "_plain")
    k = LOOP_BWD_PLAIN_N // 4

    def capture_bwd(*args, **kw):
        # the inputs of the model's first backward launch, on its first k ROIs
        # per image; ``rerun(fn)`` calls ``fn`` on them for the feature cotangent
        if not captured:
            if loop:
                feat, rois, gate, src, _, g, *rest = args
                sub = [t[:, :k].contiguous() for t in (rois, gate, src)]
                g_sub = g[:, :, :k].contiguous()
                captured.append(lambda fn, **x: fn(feat, *sub, None, g_sub, *rest,
                                                    need_gate=False, **x))
            else:
                feat, rois, gate, _, g, *rest = args
                src = kw.get("src")
                sub = [t[:, :k].contiguous() for t in (rois, gate)]
                s_sub = None if src is None else src[:, :k].contiguous()
                g_sub = g[:, :k].contiguous()
                captured.append(lambda fn, **x: fn(feat, *sub, None, g_sub, *rest,
                                                    need_gate=False, src=s_sub, **x))
        return kernel_bwd(*args, **kw)

    hooks = [model.roi_heads.pooler.register_forward_hook(pooled),
             model.proposal_generator.register_forward_hook(proposed)]
    setattr(bwd_mod, bwd_name, capture_bwd)
    torch.cuda.reset_peak_memory_stats(dev)
    counters_to_zero(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        trainer.train()
        torch.cuda.synchronize()
    finally:
        setattr(bwd_mod, bwd_name, kernel_bwd)
        for h in hooks:
            h.remove()
    dt = time.perf_counter() - t0
    other = read_counters(mods)
    launches, bwd_launches = (other.pop(c) for c in counters)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want_bwd = n_chunks * iters if freeze_at <= 4 else 0
    if (launches, bwd_launches) != (n_chunks * iters, want_bwd) or any(other.values()):
        raise AssertionError(f"{tag}: launches {counters} {launches}, {bwd_launches}, others "
                             f"{other} (expected {n_chunks * iters}, {want_bwd}, 0)")
    if rows != [3 if loop else 1] * (n_chunks * iters):
        raise AssertionError(f"{tag}: pooled rows per chunk {rows}")
    if mrrp and branches != set(range(N_BRANCH)):
        raise AssertionError(f"{tag}: RPN proposals from branches {sorted(branches)} only")
    if (mrrp or kind == "align") and freeze_at <= 4:
        got, _ = captured[0](kernel_bwd)
        want, _ = captured[0](plain_bwd, max_elems=1 << 28)
        ok, err = near(got, want, 2.0 ** -7)
        if not ok:
            raise AssertionError(f"{tag}: the model's {bwd_name} launch, on {k} ROIs per image, "
                                 f"differs from plain: max |err| {err}")
        log(f"{tag}: the model's first {bwd_name} launch, re-run on its first {k} ROIs per "
            f"image, ~= plain (one bf16 step); max |err| {err:.3g}")
        del got, want
    del captured[:]
    with open(os.path.join(out_dir, "metrics.json")) as f:
        records = [json.loads(line) for line in f]
    if [r["iteration"] for r in records] != [0, iters - 1]:
        raise AssertionError(f"{tag}: metrics of iterations {[r['iteration'] for r in records]}")
    for r in records:
        if not all(k in r and math.isfinite(r[k]) for k in LOSSES + ("grad_norm",)):
            raise AssertionError(f"{tag}: losses missing or not finite: {r}")
    # every trainable parameter was updated (nonzero momentum), and the DAN's
    # weights (and res5's, where it trains) changed; other tensors' first
    # updates, at the warmup rate (2.5e-6; 2.5e-7 for VGG16's recipe), can be
    # below their float32 resolution. The miner's det bias has a zero
    # gradient (a softmax over proposals ignores a shift).
    state = trainer.step.optimizer.state
    must_move = {"roi_heads.box_head.fc1.weight", "roi_heads.box_head.fc2.weight"}
    changed = 0
    for n, p in model.named_parameters():
        same = torch.equal(p, before[n])
        if not p.requires_grad:
            if not same:
                raise AssertionError(f"{tag}: frozen parameter {n} changed")
            continue
        changed += not same
        buf = state.get(p, {}).get("momentum_buffer")
        if n != "roi_heads.object_miner.det.bias" and (buf is None or not bool(buf.any())):
            raise AssertionError(f"{tag}: trainable parameter {n} was not updated")
        if same and (n in must_move or (".res5." in n and p.dim() >= 2)):
            raise AssertionError(f"{tag}: trainable weight {n} did not move")
    trainable = sum(p.requires_grad for p in model.parameters())
    # the JAX package's freeze stages: res5; or VGG16's plain5 and plain1,
    # which falls through to stage 5
    stages = {n.split(".")[1] for n, p in model.named_parameters()
              if n.startswith("backbone.") and p.requires_grad}
    want_stages = set() if freeze_at > 4 else ({"plain1", "plain5"} if vgg else {"res5"})
    if stages != want_stages:
        raise AssertionError(f"{tag}: trainable backbone stages {sorted(stages)} with FREEZE_AT "
                             f"{freeze_at}")
    del before
    log(f"{tag} slice: train() ran {iters} iterations of B={TB} {TH}x{TW} ({iters // 4} updates) "
        f"in {dt:.3f} s = {TB * iters / dt:.3f} images/s, the first iteration's set-up and the "
        f"final checkpoint save included; pool launches {launches} ({rows[0]} rows per chunk), "
        f"backward launches {bwd_launches}; trainable backbone stages {sorted(stages)}; RPN "
        f"proposals from branches {sorted(branches)}; "
        f"losses finite at iterations 0 and {iters - 1} "
        f"({', '.join(f'{k} {records[-1][k]:.4f}' for k in LOSSES)}); frozen parameters "
        f"bit-identical, trainable ones updated, {changed} of {trainable} trainable tensors "
        f"changed; peak memory {peak_gb:.3f} GB")
    if resume_check:
        resumed = WSOVODTrainer(cfg, iter(()), embeddings=emb, resume=True, device=dev)
        if not resumed.resumed or resumed.step.step != iters or resumed.step.updates != iters // 4:
            raise AssertionError(f"{tag}: resumed at step {resumed.step.step}")
        for (n, p), q in zip(model.named_parameters(), resumed.model.parameters()):
            s_, t_ = trainer.step.optimizer.state.get(p), resumed.step.optimizer.state.get(q)
            if not torch.equal(p, q) or (s_ is None) != (t_ is None) or (
                    s_ is not None and not torch.equal(s_["momentum_buffer"], t_["momentum_buffer"])):
                raise AssertionError(f"{tag}: {n} or its momentum differs after resume")
        del resumed
        torch.cuda.empty_cache()
        log(f"{tag} checkpoint: model_final resumed at iteration {iters}, parameters and momentum "
            f"bit-identical")
    shutil.rmtree(out_dir, ignore_errors=True)
    split = train_split(torch, trainer, batches, trainer.embeddings, tag)
    log(f"{tag} split (ms, B={TB}, synchronised phases; optimizer once per {trainer.step.iter_size} "
        f"iterations): " + json.dumps({k: (round(v, 3) if isinstance(v, float) else
                                          {a: round(b, 3) for a, b in v.items()})
                                      for k, v in split.items()}))
    log(f"{tag} steady state: {TB * 1e3 / split['ms_per_iteration']:.3f} images/s")
    del trainer, model
    torch.cuda.empty_cache()
    return launches, bwd_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU only",
              file=sys.stderr)
        return 2
    from wsovod_torch import kernels
    from wsovod_torch.ops import roi_align as ra
    from wsovod_torch.ops import roi_pool as rp
    from wsovod_torch.scripts import bench_i8walk as walk
    from wsovod_torch.scripts import bench_vpu_pack as fold

    mods = {"rp": rp, "ra": ra, "fold": fold, "walk": walk}

    # ---- 1. device and build
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    sources = ["roi_pool_gated.cu", "roi_loop_pool_gated.cu", "roi_pool_gated_bwd.cu",
               "roi_loop_pool_gated_bwd.cu", "roi_align_gated.cu", "roi_align_gated_bwd.cu",
               "row_fold.cu", "row_walk.cu"]
    t0 = time.perf_counter()
    libs = kernels.build_all(sources)
    for src in sources:
        kernels.load(src)
    log(f"built {sorted(os.path.relpath(p, REPO) for p in libs.values())} with nvcc "
        f"{' '.join(kernels.ARCH_FLAGS)} in {time.perf_counter() - t0:.3f} s")
    for src in sources:
        for line in kernels.BUILD_LOG.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}:", line.strip())

    # ---- 2., 3. kernels vs plain at the slices' shapes
    records = {"roi_pool_gated": phase_pool_kernel(torch, dev, rp),
               "roi_loop_pool_gated": phase_loop_kernel(torch, dev, rp),
               "roi_pool_gated_routed": phase_routed_kernel(torch, dev, rp),
               **phase_align_kernel(torch, dev, ra),
               **phase_emission_kernels(torch, dev, rp, ra),
               **phase_level_kernels(torch, dev, rp),
               **phase_walk_kernels(torch, dev, fold, walk)}
    int8_gemms = phase_int8_gemms(torch, dev)

    # ---- 4., 5. the inference slices
    emb = torch.randn(80, 512, generator=torch.Generator().manual_seed(2)).to(dev)
    by_path = {name: {} for name in records}
    by_path.update({name: {} for name in ("roi_pool_gated_bwd", "roi_loop_pool_gated_bwd",
                                          "roi_pool_gated_bwd_routed", "roi_align_gated_bwd")})
    stages = {}
    for name, tag, config, pooler in (
            ("roi_pool_gated", "plain", PLAIN_CONFIG, None),
            ("roi_loop_pool_gated", "mrrp", MRRP_CONFIG, None),
            ("roi_pool_gated", "vgg", VGG_CONFIG, None),
            ("roi_pool_gated_routed", "mrrp-vgg", MRRP_VGG_CONFIG, None),
            ("roi_align_gated", "align", PLAIN_CONFIG, ALIGN),
            ("roi_align_gated_routed", "mrrp-align", MRRP_CONFIG, ALIGN),
            ("roi_align_gated", "align-approx", PLAIN_CONFIG, ALIGN),
            ("roi_pool_levels", "swin-fpn", SWIN_CONFIG, None),
            ("roi_loop_pool_levels", "swin-fpn-loop", SWIN_CONFIG, "ROILoopPool")):
        launches, err, stages[tag] = run_slice(torch, dev, mods, tag, config, emb, pooler,
                                               "pallas_approx" if tag == "align-approx" else None)
        by_path[name][tag] = launches
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    # the int8 slices: the WSR-50-DC5 YAMLs with both int8 keys (the JAX
    # package's default inference); the ROIPool and the ROILoopPool emit
    # through their maxabs kernels, the align through its bf16 kernel
    for name, tag, config, pooler, ref in (
            ("roi_pool_gated_maxabs", "plain-int8", PLAIN_CONFIG, None, "plain"),
            ("roi_loop_pool_gated_maxabs", "mrrp-int8", MRRP_CONFIG, None, "mrrp"),
            ("roi_align_gated", "align-int8", PLAIN_CONFIG, ALIGN, "align")):
        launches, err, stages[tag] = run_slice(torch, dev, mods, tag, config, emb, pooler,
                                               quant="int8", bf16_stages=stages[ref])
        by_path[name][tag] = launches
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    for name, tag in (("roi_pool_gated", "plain"), ("roi_loop_pool_gated", "mrrp"),
                      ("roi_pool_gated_routed", "mrrp-vgg"), ("roi_align_gated", "align"),
                      ("roi_align_gated_routed", "mrrp-align"),
                      ("roi_pool_gated_maxabs", "plain-int8"),
                      ("roi_loop_pool_gated_maxabs", "mrrp-int8"),
                      ("roi_pool_levels", "swin-fpn"), ("roi_loop_pool_levels", "swin-fpn-loop")):
        records[name]["launches"] = by_path[name][tag]

    # ---- 6., 7. the backward kernels vs plain; 8.-12. the train slices
    records["roi_pool_gated_bwd"] = phase_bwd_kernel(torch, dev, rp)
    records["roi_loop_pool_gated_bwd"] = phase_loop_bwd_kernel(torch, dev, rp)
    records["roi_pool_gated_bwd_routed"] = phase_routed_bwd_kernel(torch, dev, rp)
    records["roi_align_gated_bwd"] = phase_align_bwd_kernel(torch, dev, ra)
    for tag, config, freeze_at, iters, pool, bwd_name, pooler in (
            ("train-plain", PLAIN_CONFIG, 5, TRAIN_ITERS, "roi_pool_gated", "roi_pool_gated_bwd",
             None),
            ("train-res5", PLAIN_CONFIG, 4, RES5_ITERS, "roi_pool_gated", "roi_pool_gated_bwd",
             None),
            ("train-mrrp", MRRP_CONFIG, 5, MRRP_ITERS, "roi_loop_pool_gated",
             "roi_loop_pool_gated_bwd", None),
            ("train-mrrp-res5", MRRP_CONFIG, 4, MRRP_RES5_ITERS, "roi_loop_pool_gated",
             "roi_loop_pool_gated_bwd", None),
            ("train-mrrp-vgg", MRRP_VGG_CONFIG, 5, VGG_ITERS, "roi_pool_gated_routed",
             "roi_pool_gated_bwd_routed", None),
            ("train-mrrp-vgg-plain5", MRRP_VGG_CONFIG, 4, VGG_ITERS, "roi_pool_gated_routed",
             "roi_pool_gated_bwd_routed", None),
            ("train-align", PLAIN_CONFIG, 5, ALIGN_ITERS, "roi_align_gated",
             "roi_align_gated_bwd", ALIGN),
            ("train-align-res5", PLAIN_CONFIG, 4, ALIGN_ITERS, "roi_align_gated",
             "roi_align_gated_bwd", ALIGN)):
        launches, bwd = run_train(torch, dev, mods, tag, config, freeze_at, iters, emb,
                                  resume_check=freeze_at == 5, pooler=pooler)
        by_path[pool][tag] = launches
        by_path[bwd_name][tag] = bwd
    for name, tag in (("roi_pool_gated_bwd", "train-res5"),
                      ("roi_loop_pool_gated_bwd", "train-mrrp-res5"),
                      ("roi_pool_gated_bwd_routed", "train-mrrp-vgg-plain5"),
                      ("roi_align_gated_bwd", "train-align-res5")):
        records[name]["launches"] = by_path[name][tag]

    # ---- 13. result lines
    meta = {
        "roi_pool_gated": ("wsovod_torch/kernels/csrc/roi_pool_gated.cu",
                           "wsovod_tpu/ops/pallas/roi_pool_fused.py:1585"),
        "roi_loop_pool_gated": ("wsovod_torch/kernels/csrc/roi_loop_pool_gated.cu",
                                "wsovod_tpu/ops/pallas/roi_pool_fused.py:1585"),
        # the same kernel with a per-ROI source copy: the pallas_call of
        # roi_pool_fused_batched with src_tbl, reached from
        # roi_pool_fused_branched_ad (loop_pool=False), and its VJP
        "roi_pool_gated_routed": ("wsovod_torch/kernels/csrc/roi_pool_gated.cu",
                                  "wsovod_tpu/ops/pallas/roi_pool_fused.py:2085"),
        "roi_pool_gated_bwd": ("wsovod_torch/kernels/csrc/roi_pool_gated_bwd.cu",
                               "wsovod_tpu/ops/pallas/roi_pool_fused.py:2146"),
        "roi_loop_pool_gated_bwd": ("wsovod_torch/kernels/csrc/roi_loop_pool_gated_bwd.cu",
                                    "wsovod_tpu/ops/pallas/roi_pool_fused.py:2240"),
        "roi_pool_gated_bwd_routed": ("wsovod_torch/kernels/csrc/roi_pool_gated_bwd.cu",
                                      "wsovod_tpu/ops/pallas/roi_pool_fused.py:2240"),
        # 2.6: the fused batched ROIAlignV2 (its windowed mode, 2.8's numbers,
        # roi_align_kernel.py:307, is timed in window_ms and launched by the
        # align-approx slice); 2.7: the per-image exact align the MRRP pooler
        # runs per branch copy; their backward
        "roi_align_gated": ("wsovod_torch/kernels/csrc/roi_align_gated.cu",
                            "wsovod_tpu/ops/pallas/roi_align_fused.py:408"),
        "roi_align_gated_routed": ("wsovod_torch/kernels/csrc/roi_align_gated.cu",
                                   "wsovod_tpu/ops/pallas/roi_align_kernel.py:554"),
        "roi_align_gated_bwd": ("wsovod_torch/kernels/csrc/roi_align_gated_bwd.cu",
                                "wsovod_tpu/ops/pallas/roi_align_fused.py:453"),
        # 2.3: the emission modes of the same pallas_call (_write_out :833)
        # and the align's int8 emission
        "roi_pool_gated_maxabs": ("wsovod_torch/kernels/csrc/roi_pool_gated.cu",
                                  "wsovod_tpu/ops/pallas/roi_pool_fused.py:2085"),
        "roi_pool_gated_int8": ("wsovod_torch/kernels/csrc/roi_pool_gated.cu",
                                "wsovod_tpu/ops/pallas/roi_pool_fused.py:2085"),
        "roi_pool_gated_tile8": ("wsovod_torch/kernels/csrc/roi_pool_gated.cu",
                                 "wsovod_tpu/ops/pallas/roi_pool_fused.py:2085"),
        "roi_loop_pool_gated_maxabs": ("wsovod_torch/kernels/csrc/roi_loop_pool_gated.cu",
                                       "wsovod_tpu/ops/pallas/roi_pool_fused.py:2085"),
        "roi_loop_pool_gated_int8": ("wsovod_torch/kernels/csrc/roi_loop_pool_gated.cu",
                                     "wsovod_tpu/ops/pallas/roi_pool_fused.py:2085"),
        "roi_align_gated_int8": ("wsovod_torch/kernels/csrc/roi_align_gated.cu",
                                 "wsovod_tpu/ops/pallas/roi_align_fused.py:408"),
        # 2.5: the per-image pools the JAX multi-level pooler runs on every
        # level, here the level-routed modes of the two forward kernels
        "roi_pool_levels": ("wsovod_torch/kernels/csrc/roi_pool_gated.cu",
                            "wsovod_tpu/ops/pallas/roi_pool_kernel.py:281"),
        "roi_loop_pool_levels": ("wsovod_torch/kernels/csrc/roi_loop_pool_gated.cu",
                                 "wsovod_tpu/ops/pallas/roi_pool_kernel.py:333"),
        # 2.9: the TPU microbenchmarks' walks, on no model path
        "row_fold": ("wsovod_torch/kernels/csrc/row_fold.cu", "scripts/bench_vpu_pack.py:51"),
        "row_walk": ("wsovod_torch/kernels/csrc/row_walk.cu", "scripts/bench_i8walk.py:80"),
    }
    extra = ("n_rois", "plain_n_rois", "ms_at_plain_n", "window_ms", "window_plain_ms", "routed_ms",
             "routed_plain_ms", "rows3_ms", "rows3_plain_ms", "rois_per_level", "cases", "ms_rows1",
             "ms_rows2", "dead_ms", "single_copy_ms", "single_copy_bound_ms")
    log("int8 GEMMs (torch._int_mm, not a kernel of the port): "
        + json.dumps({k: round(v, 3) for k, v in int8_gemms.items()}))
    log(card)
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
        "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        # no single PyTorch call computes a gated RoIPool, ROILoopPool, a
        # gated, routed ROIAlign or their backward (and the card's host has
        # no torchvision), nor walks windows of one resident map
        "library_ms": None,
        "launches_by_path": by_path[name],
        **{k: r[k] for k in extra if k in r},
    } for name, r in records.items()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
