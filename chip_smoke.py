#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``wsovod_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the last line is printed:

1. Device and build: the card's name and power limit (``nvidia-smi``), TF32
   off for matmuls and convolutions, both CUDA kernels built from
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
   bit-for-bit; ``rows=1`` equals row 0 of ``rows=3``; both times.
4. The plain slice: ``build_model`` on ``configs/COCO-Detection/
   WSOVOD_WSR_50_DC5_1x.yaml``; 5. the MRRP slice, the same on
   ``WSOVOD_MRRP_WSR_50_DC5_1x.yaml`` (three branches at test). Each with TTA
   off, bf16 compute, seeded random parameters, B=2 synthetic 688x1056
   images with 4000 SAM proposals each and an 80x512 class-embedding matrix,
   through ``inference_on_dataset``. Checks: the launch counts, set to 0
   just before the run and read just after, rose by one per channel chunk
   and batch for the slice's kernel and stayed 0 for the other; detections
   are finite and every image has some; the chunks the model pooled on the
   first batch equal the plain version called directly on the same card
   tensors; under MRRP the RPN's proposals come from more than one branch.
   Prints images/s, the per-stage wall times, peak memory, and the device's
   busy share and top device times of one batch under ``torch.profiler``
   (trace and kernel table in ``profiles/``).
6. The gated ROIPool's backward kernel against its plain version at the
   training shape (res5 ``[4, 100, 152, 2048]`` of B=4 800x1216 images,
   5024 ROIs per image from the same box mix plus edge rows, a post-ReLU map
   on a 0.25 grid so bins tie, gate-0 rows), bfloat16 and float32, both
   cotangents: one chunk at full N and every chunk at a reduced N, to float
   tolerance (float32 atomics); its time, the plain version's and the bound.
7. The ``train-plain`` slice: ``WSOVODTrainer`` on ``WSOVOD_WSR_50_DC5_1x.yaml``
   at full width (``FREEZE_AT`` 5 as shipped, BBOX_REFINE off for want of a
   SAM checkpoint, the recipe scaled to one card: ``BASE_LR`` 0.0025,
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
8. The ``train-res5`` slice: the same with ``FREEZE_AT`` 4 for 4 iterations
   (1 update): res5's weights change and the backward kernel launches 4
   times per iteration.
9. The card line, one JSON line of kernel records (with each kernel's bound
   on this card computed from this run's inputs), and the result line.

It imports no JAX and nothing of ``wsovod_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(REPO, "configs", "COCO-Detection")
PLAIN_CONFIG = os.path.join(CONFIGS, "WSOVOD_WSR_50_DC5_1x.yaml")
MRRP_CONFIG = os.path.join(CONFIGS, "WSOVOD_MRRP_WSR_50_DC5_1x.yaml")
B, H, W, S = 2, 688, 1056, 4000  # images, test resolution, SAM proposals per image
N_ROIS = 1024 + S  # RPN post-NMS top-k + SAM
FEAT = (B, 86, 132, 2048)  # res5 at stride 8
N_BRANCH = 3  # MRRP branches at test
C_TAKE = 512
N_CHUNKS = FEAT[3] // C_TAKE
N_BATCHES = 3  # timed batches of B images, per slice
REDUCED_N = 256  # ROIs per image where every chunk is checked against the plain pools
TB, TH, TW = 4, 800, 1216  # training: images per iteration and their size
TRAIN_FEAT = (TB, 100, 152, 2048)  # res5 at stride 8
TRAIN_ITERS, RES5_ITERS = 8, 4  # iterations of the two train slices (ITER_SIZE 4)
PROFILE_DIR = os.path.join(REPO, "profiles")  # git-ignored
# NVIDIA H100 SXM data sheet: HBM rate, and the float32 rate outside the
# tensor cores (the pool kernels compare in float32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """``(fn(), ms)`` of one call, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def bound(pixels: int, out_elems: int, in_bytes: int, out_bytes: int):
    """Least time (ms) on the card for a pool call, and what sets it: the
    bytes it must move (each input read once, each output written once) over
    HBM's rate, against its operations (one compare per bin pixel and
    channel, one gate multiply per output) over the float32 rate."""
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = (pixels + out_elems) / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    bound_ms, bound_by = bound(pixels, out_elems, in_bytes, out_elems * 2)
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
    bound_ms, bound_by = bound(pixels, out_elems, in_bytes, out_elems * esize)
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


def run_slice(torch, dev, rp, tag, config, emb):
    """Drive one slice through ``inference_on_dataset`` and check it (see
    the module docstring); returns the slice kernel's launch count."""
    from wsovod_torch import get_cfg
    from wsovod_torch.engine.evaluator import inference_on_dataset
    from wsovod_torch.models import build_model

    cfg = get_cfg()
    cfg.merge_from_file(config)
    cfg.TEST.AUG.ENABLED = False
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    loop = cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE == "ROILoopPool"
    counter, other = ("LOOP_LAUNCHES", "LAUNCHES") if loop else ("LAUNCHES", "LOOP_LAUNCHES")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    log(f"{tag} model: {os.path.basename(config)}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f}M parameters, built in "
        f"{time.perf_counter() - t0:.3f} s")
    warm = make_batches(1, seed=7)
    batches = make_batches(N_BATCHES)
    inference_on_dataset(model, warm, DetectionCounter(), embeddings=emb)  # warm-up
    torch.cuda.synchronize()

    captured, rpn_out = [], []

    def capture(mod, inp, out):
        if len(captured) < N_CHUNKS:  # the first batch's chunks
            captured.append((inp, out))

    def capture_rpn(mod, inp, out):
        if not rpn_out:
            rpn_out.append(out)

    hooks = [model.roi_heads.pooler.register_forward_hook(capture),
             model.proposal_generator.register_forward_hook(capture_rpn)]
    torch.cuda.reset_peak_memory_stats(dev)
    setattr(rp, counter, 0)
    setattr(rp, other, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = inference_on_dataset(model, batches, DetectionCounter(), embeddings=emb)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, other_launches = getattr(rp, counter), getattr(rp, other)
    for h in hooks:
        h.remove()
    n_images = B * N_BATCHES
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    if launches != N_CHUNKS * N_BATCHES or other_launches != 0:
        raise AssertionError(f"{tag}: {counter} {launches} (expected {N_CHUNKS * N_BATCHES}), "
                             f"{other} {other_launches} (expected 0)")
    if len(counts) != n_images or min(counts.values()) <= 0:
        raise AssertionError(f"{tag}: images without detections: {counts}")
    if len(captured) != N_CHUNKS:
        raise AssertionError(f"{tag}: captured {len(captured)} pooled chunks")
    max_err = 0.0
    for k, ((feat, boxes, gate, c_base, c_take, src), out) in enumerate(captured):
        assert out.shape == (B, N_ROIS, 7, 7, C_TAKE), out.shape
        if loop:
            assert feat.shape[0] == N_BRANCH * B, feat.shape
            want = rp.roi_loop_pool_gated_plain(feat, boxes, gate, src, c_base, c_take, 1, 7, 0.125,
                                                1.8, max_elems=1 << 28)[0]
        else:
            want = rp.roi_pool_gated_plain(feat, boxes, gate, c_base, c_take, 7, 0.125,
                                           max_elems=1 << 28)
        max_err = max(max_err, (out.float() - want.float()).abs().max().item())
        if not torch.equal(out, want):
            raise AssertionError(f"{tag}: model chunk {k} differs from the plain pool")
    rpn = rpn_out[0]
    branches = torch.unique(torch.div(rpn.level_ids[rpn.valid], 1000, rounding_mode="floor")).tolist()
    if loop and len(branches) < 2:
        raise AssertionError(f"{tag}: RPN proposals from branches {branches} only")
    log(f"{tag} slice: {n_images} images in {dt:.3f} s = {n_images / dt:.3f} images/s (B={B}, "
        f"{H}x{W}, {N_ROIS} ROIs/image, bf16); detections/image min {min(counts.values())} "
        f"max {max(counts.values())}; {counter} {launches}; first batch's {len(captured)} pooled "
        f"chunks == plain; RPN proposals from branches {branches}; peak memory {peak_gb:.3f} GB")
    batch0 = {k: torch.as_tensor(batches[0][k]).to(dev)
              for k in ("images", "image_sizes", "sam_boxes", "sam_scores", "sam_valid")}
    st = stage_times(torch, model, batch0, emb)
    log(f"{tag} stages (ms per B=2 batch, synchronised): "
        + json.dumps({k: round(v, 3) for k, v in st.items()}))
    profile_batch(torch, model, batch0, emb, PROFILE_DIR, tag)
    del model
    torch.cuda.empty_cache()
    return launches, max_err


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
        err = (got_f.float() - want_f.float()).abs()
        max_err = max(max_err, err.max().item())
        scale = want_f.float().abs().max()
        if not (scale > 0 and (err <= rtol * want_f.float().abs() + 1e-5 * scale).all()):
            raise AssertionError(f"roi_pool_gated_bwd g_feat != plain ({what}): max |err| "
                                 f"{err.max().item()}, max |plain| {scale.item()}")
        gerr = (got_g - want_g).abs()
        if not (gerr <= 1e-4 * want_g.abs() + 1e-4 * want_g.abs().max()).all():
            raise AssertionError(f"roi_pool_gated_bwd g_gate != plain ({what}): max |err| "
                                 f"{gerr.max().item()}")
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
    bound_ms, bound_by = bound(2 * pixels, out_elems, in_bytes, chunk_elems * 4)
    log(f"roi_pool_gated_bwd bf16 {list(TRAIN_FEAT)} x {N_ROIS} ROIs, one 512-channel chunk, "
        f"feature cotangent: kernel {times['ms']:.3f} ms, plain {times['plain_ms']:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: {(in_bytes + chunk_elems * 4) / 1e6:.1f} MB, "
        f"{2 * pixels / 1e9:.3f} G compares)")
    return {"max_abs_err": max_err, "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by}


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


def run_train(torch, dev, rp, tag, freeze_at, iters, emb, resume_check):
    """Drive ``WSOVODTrainer.train()`` for ``iters`` iterations and check it
    (see the module docstring); returns ``(pool launches, backward
    launches)``."""
    from wsovod_torch import get_cfg
    from wsovod_torch.engine.trainer import WSOVODTrainer

    cfg = get_cfg()
    cfg.merge_from_file(PLAIN_CONFIG)
    cfg.TEST.AUG.ENABLED = False
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
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
    if (tc.WSOVOD.ITER_SIZE, tc.SOLVER.BASE_LR, tc.WSOVOD.BBOX_REFINE.ENABLE) != (4, 0.0025, False):
        raise AssertionError(f"{tag}: ITER_SIZE {tc.WSOVOD.ITER_SIZE}, BASE_LR {tc.SOLVER.BASE_LR}, "
                             f"BBOX_REFINE {tc.WSOVOD.BBOX_REFINE.ENABLE}")
    model = trainer.model
    log(f"{tag} trainer: {os.path.basename(PLAIN_CONFIG)}, FREEZE_AT {freeze_at}, "
        f"{sum(p.numel() for p in model.parameters() if p.requires_grad) / 1e6:.3f}M trainable of "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f}M parameters, built in "
        f"{time.perf_counter() - t0:.3f} s")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats(dev)
    rp.LAUNCHES = rp.BWD_LAUNCHES = rp.LOOP_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, bwd_launches, loop = rp.LAUNCHES, rp.BWD_LAUNCHES, rp.LOOP_LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want_bwd = N_CHUNKS * iters if freeze_at <= 4 else 0
    if (launches, bwd_launches, loop) != (N_CHUNKS * iters, want_bwd, 0):
        raise AssertionError(f"{tag}: launches pool {launches}, backward {bwd_launches}, loop "
                             f"{loop} (expected {N_CHUNKS * iters}, {want_bwd}, 0)")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        records = [json.loads(line) for line in f]
    if [r["iteration"] for r in records] != [0, iters - 1]:
        raise AssertionError(f"{tag}: metrics of iterations {[r['iteration'] for r in records]}")
    for r in records:
        if not all(k in r and math.isfinite(r[k]) for k in LOSSES + ("grad_norm",)):
            raise AssertionError(f"{tag}: losses missing or not finite: {r}")
    # every trainable parameter was updated (nonzero momentum), and the DAN's
    # weights (and res5's, where it trains) changed; other tensors' first
    # updates, at the warmup rate (2.5e-6), can be below their float32
    # resolution. The miner's det bias has a zero gradient (a softmax over
    # proposals ignores a shift).
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
    moved_res5 = [n for n, p in model.named_parameters() if ".res5." in n and p.requires_grad]
    if (freeze_at <= 4) != bool(moved_res5):
        raise AssertionError(f"{tag}: res5 trainable {moved_res5[:2]} with FREEZE_AT {freeze_at}")
    del before
    log(f"{tag} slice: train() ran {iters} iterations of B={TB} {TH}x{TW} ({iters // 4} updates) "
        f"in {dt:.3f} s = {TB * iters / dt:.3f} images/s, the first iteration's set-up and the "
        f"final checkpoint save included; pool launches {launches}, "
        f"backward launches {bwd_launches}; losses finite at iterations 0 and {iters - 1} "
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
    sys.path.insert(0, REPO)
    from wsovod_torch import kernels
    from wsovod_torch.ops import roi_pool as rp

    # ---- 1. device and build
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    sources = ["roi_pool_gated.cu", "roi_loop_pool_gated.cu", "roi_pool_gated_bwd.cu"]
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
               "roi_loop_pool_gated": phase_loop_kernel(torch, dev, rp)}

    # ---- 4., 5. the inference slices
    emb = torch.randn(80, 512, generator=torch.Generator().manual_seed(2)).to(dev)
    by_path = {name: {} for name in ("roi_pool_gated", "roi_loop_pool_gated", "roi_pool_gated_bwd")}
    for name, tag, config in (("roi_pool_gated", "plain", PLAIN_CONFIG),
                              ("roi_loop_pool_gated", "mrrp", MRRP_CONFIG)):
        launches, err = run_slice(torch, dev, rp, tag, config, emb)
        records[name]["launches"] = by_path[name][tag] = launches
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)

    # ---- 6. the backward kernel vs plain; 7., 8. the train slices
    records["roi_pool_gated_bwd"] = phase_bwd_kernel(torch, dev, rp)
    for tag, freeze_at, iters in (("train-plain", 5, TRAIN_ITERS), ("train-res5", 4, RES5_ITERS)):
        launches, bwd = run_train(torch, dev, rp, tag, freeze_at, iters, emb,
                                  resume_check=freeze_at == 5)
        by_path["roi_pool_gated"][tag] = launches
        by_path["roi_pool_gated_bwd"][tag] = bwd
    records["roi_pool_gated_bwd"]["launches"] = by_path["roi_pool_gated_bwd"]["train-res5"]

    # ---- 6. result lines
    meta = {
        "roi_pool_gated": ("wsovod_torch/kernels/csrc/roi_pool_gated.cu",
                           "wsovod_tpu/ops/pallas/roi_pool_fused.py:1585"),
        "roi_loop_pool_gated": ("wsovod_torch/kernels/csrc/roi_loop_pool_gated.cu",
                                "wsovod_tpu/ops/pallas/roi_pool_fused.py:1585"),
        "roi_pool_gated_bwd": ("wsovod_torch/kernels/csrc/roi_pool_gated_bwd.cu",
                               "wsovod_tpu/ops/pallas/roi_pool_fused.py:2146"),
    }
    log(card)
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
        "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        # no single PyTorch call computes a gated RoIPool, ROILoopPool or
        # their backward (and the card's host has no torchvision)
        "library_ms": None,
        "launches_by_path": by_path[name],
    } for name, r in records.items()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
