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
6. The card line, one JSON line of kernel records (with each kernel's bound
   on this card computed from this run's inputs), and the result line.

It imports no JAX and nothing of ``wsovod_tpu``.
"""

from __future__ import annotations

import json
import os
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
REDUCED_N = 256  # ROIs per image where every chunk is checked against the plain loop pool
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


def pool_inputs(rng):
    """The slice's ROIs per image with edge rows, and the
    ``(objectness+1)*valid`` gate; invalid rows zeroed."""
    rois = box_mix(rng, B, N_ROIS)
    rois[:, 0] = [W - 40, H - 100, W + 160, H + 240]  # overhangs right and bottom
    rois[:, 1] = [-60, -30, 200, 150]  # overhangs left and top
    rois[:, 2] = [500, 400, 300, 200]  # degenerate: x2 < x1, y2 < y1
    rois[:, 3] = [4, 12, 100, 60]  # .5 boundaries at stride 8
    rois[:, 4] = [20, 28, 60, 68]  # outer box on .5 boundaries
    valid = rng.rand(B, N_ROIS) > 0.1
    valid[:, :5] = True
    gate = ((rng.rand(B, N_ROIS) + 1.0) * valid).astype(np.float32)
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
    sources = ["roi_pool_gated.cu", "roi_loop_pool_gated.cu"]
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

    # ---- 4., 5. the slices
    emb = torch.randn(80, 512, generator=torch.Generator().manual_seed(2)).to(dev)
    for name, tag, config in (("roi_pool_gated", "plain", PLAIN_CONFIG),
                              ("roi_loop_pool_gated", "mrrp", MRRP_CONFIG)):
        launches, err = run_slice(torch, dev, rp, tag, config, emb)
        records[name]["launches"] = launches
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)

    # ---- 6. result lines
    meta = {
        "roi_pool_gated": ("wsovod_torch/kernels/csrc/roi_pool_gated.cu",
                           "wsovod_tpu/ops/pallas/roi_pool_fused.py:1585"),
        "roi_loop_pool_gated": ("wsovod_torch/kernels/csrc/roi_loop_pool_gated.cu",
                                "wsovod_tpu/ops/pallas/roi_pool_fused.py:1585"),
    }
    log(card)
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
        "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        # no single PyTorch call computes a gated RoIPool or ROILoopPool
        # (and the card's host has no torchvision)
        "library_ms": None,
    } for name, r in records.items()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
