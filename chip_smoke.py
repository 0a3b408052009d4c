#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``wsovod_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the last line is printed:

1. Device and build: the card's name and power limit (``nvidia-smi``), TF32
   off for matmuls and convolutions, the CUDA kernel built from
   ``wsovod_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a``.
2. Kernel against its plain PyTorch version at the slice's shapes (res5
   ``[2, 86, 132, 2048]``, 5024 ROIs per image from the ``bench.py`` box mix
   plus overhanging, degenerate and invalid rows), bfloat16 and float32:
   bit-for-bit equality, and both times.
3. The slice: ``build_model`` on ``configs/COCO-Detection/
   WSOVOD_WSR_50_DC5_1x.yaml`` (TTA off, bf16 compute, seeded random
   parameters), B=2 synthetic 688x1056 images with 4000 SAM proposals each
   and an 80x512 class-embedding matrix, through ``inference_on_dataset``.
   Checks: the kernel's launch count rose by one per channel chunk and batch,
   detections are finite and every image has some, and the chunks the model
   pooled on the first batch equal the plain version called directly on the
   same card tensors. Prints images/s and the per-stage wall times.
4. One batch under ``torch.profiler``: the device's busy share and the top
   device times; the trace and the kernel table go to ``profiles/``.
5. The card line, one JSON line of kernel records, and the result line.

It imports no JAX and nothing of ``wsovod_tpu`` but its YAML config.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "COCO-Detection", "WSOVOD_WSR_50_DC5_1x.yaml")
B, H, W, S = 2, 688, 1056, 4000  # images, test resolution, SAM proposals per image
N_ROIS = 1024 + S  # RPN post-NMS top-k + SAM
FEAT = (B, 86, 132, 2048)  # res5 at stride 8
C_TAKE = 512
N_BATCHES = 6  # timed batches of B images
PROFILE_DIR = os.path.join(REPO, "profiles")  # git-ignored


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


def phase_kernel(torch, dev, rp):
    """Kernel vs plain at the slice's shapes; returns (max_abs_err, ms, plain_ms)."""
    rng = np.random.RandomState(0)
    rois = box_mix(rng, B, N_ROIS)
    rois[:, 0] = [W - 40, H - 100, W + 160, H + 240]  # overhangs right and bottom
    rois[:, 1] = [-60, -30, 200, 150]  # overhangs left and top
    rois[:, 2] = [500, 400, 300, 200]  # degenerate: x2 < x1, y2 < y1
    rois[:, 3] = [4, 12, 100, 60]  # .5 boundaries at stride 8
    valid = rng.rand(B, N_ROIS) > 0.1
    valid[:, :4] = True
    gate = ((rng.rand(B, N_ROIS) + 1.0) * valid).astype(np.float32)
    rois = np.where(valid[..., None], rois, 0.0).astype(np.float32)
    rois_t = torch.from_numpy(rois).to(dev)
    gate_t = torch.from_numpy(gate).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    feat32 = torch.randn(FEAT, generator=g, device=dev)
    max_err, ms, plain_ms = 0.0, None, None
    for dtype, chunks in ((torch.bfloat16, range(0, FEAT[3], C_TAKE)), (torch.float32, [C_TAKE])):
        feat = feat32.to(dtype).contiguous()
        for c_base in chunks:
            got = rp.roi_pool_gated(feat, rois_t, gate_t, c_base, C_TAKE, 7, 0.125)
            want = rp.roi_pool_gated_plain(feat, rois_t, gate_t, c_base, C_TAKE, 7, 0.125,
                                           max_elems=1 << 28)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain ({dtype}, c_base {c_base}): max |err| {err}")
        if dtype == torch.bfloat16:
            ms = cuda_ms(lambda: rp.roi_pool_gated(feat, rois_t, gate_t, C_TAKE, C_TAKE, 7, 0.125), 20)
            plain_ms = cuda_ms(lambda: rp.roi_pool_gated_plain(
                feat, rois_t, gate_t, C_TAKE, C_TAKE, 7, 0.125, max_elems=1 << 28), 1)
        log(f"kernel == plain, {str(dtype)[6:]}, chunks at {list(chunks)}: exact")
    log(f"roi_pool_gated bf16 [2,86,132,2048] x 5024 ROIs, one 512-channel chunk: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return max_err, ms, plain_ms


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


def profile_batch(torch, model, batch, emb, out_dir):
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
    prof.export_chrome_trace(os.path.join(out_dir, "slice_trace.json"))
    events = prof.key_averages()
    dev_attr = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    rows = sorted(events, key=lambda e: getattr(e, dev_attr), reverse=True)
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    with open(os.path.join(out_dir, "slice_kernels.txt"), "w") as f:
        f.write(events.table(sort_by=dev_attr, row_limit=60))
    log(f"profile: wall {wall_ms:.3f} ms, device kernel time {busy_ms:.3f} ms "
        f"(busy share {busy_ms / wall_ms:.3f} if kernels do not overlap)")
    for e in rows[:15]:
        log(f"  {getattr(e, dev_attr) / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from wsovod_torch import get_cfg, kernels
    from wsovod_torch.engine.evaluator import inference_on_dataset
    from wsovod_torch.models import build_model
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
    t0 = time.perf_counter()
    lib = kernels.build("roi_pool_gated.cu")
    kernels.load("roi_pool_gated.cu")
    log(f"built {os.path.relpath(lib, REPO)} with nvcc {' '.join(kernels.ARCH_FLAGS)} "
        f"in {time.perf_counter() - t0:.3f} s")
    for line in kernels.BUILD_LOG.get("roi_pool_gated.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # ---- 2. kernel vs plain at the slice's shapes
    max_err, kernel_ms, plain_ms = phase_kernel(torch, dev, rp)

    # ---- 3. the slice
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.TEST.AUG.ENABLED = False
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    log(f"model: WSR-50-DC5 WSOVOD, {sum(p.numel() for p in model.parameters()) / 1e6:.3f}M "
        f"parameters, built in {time.perf_counter() - t0:.3f} s")
    emb = torch.randn(80, 512, generator=torch.Generator().manual_seed(2)).to(dev)
    warm = make_batches(1, seed=7)
    batches = make_batches(N_BATCHES)
    inference_on_dataset(model, warm, DetectionCounter(), embeddings=emb)  # warm-up
    torch.cuda.synchronize()

    captured = []

    def capture(mod, inp, out):
        if len(captured) < FEAT[3] // C_TAKE:  # the first batch's chunks
            captured.append((inp, out))

    hook = model.roi_heads.pooler.register_forward_hook(capture)
    torch.cuda.reset_peak_memory_stats(dev)
    rp.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = inference_on_dataset(model, batches, DetectionCounter(), embeddings=emb)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = rp.LAUNCHES
    hook.remove()
    n_images = B * N_BATCHES
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    want_launches = (FEAT[3] // C_TAKE) * N_BATCHES
    if launches != want_launches:
        raise AssertionError(f"kernel launched {launches} times, expected {want_launches}")
    if len(counts) != n_images or min(counts.values()) <= 0:
        raise AssertionError(f"images without detections: {counts}")
    for k, ((feat, boxes, gate, c_base, c_take), out) in enumerate(captured):
        assert out.shape == (B, N_ROIS, 7, 7, C_TAKE), out.shape
        want = rp.roi_pool_gated_plain(feat, boxes, gate, c_base, c_take, 7, 0.125,
                                       max_elems=1 << 28)
        max_err = max(max_err, (out.float() - want.float()).abs().max().item())
        if not torch.equal(out, want):
            raise AssertionError(f"model chunk {k} differs from the plain pool")
    if len(captured) != FEAT[3] // C_TAKE:
        raise AssertionError(f"captured {len(captured)} pooled chunks")
    log(f"slice: {n_images} images in {dt:.3f} s = {n_images / dt:.3f} images/s (B={B}, "
        f"{H}x{W}, {N_ROIS} ROIs/image, bf16); detections/image min {min(counts.values())} "
        f"max {max(counts.values())}; kernel launches {launches}; first batch's "
        f"{len(captured)} pooled chunks == plain; peak memory {peak_gb:.3f} GB")
    batch0 = {k: torch.as_tensor(batches[0][k]).to(dev)
              for k in ("images", "image_sizes", "sam_boxes", "sam_scores", "sam_valid")}
    st = stage_times(torch, model, batch0, emb)
    log("stages (ms per B=2 batch, synchronised): " + json.dumps({k: round(v, 3) for k, v in st.items()}))

    # ---- 4. profile of one batch
    profile_batch(torch, model, batch0, emb, PROFILE_DIR)

    # ---- 5. result lines
    log(card)
    log(json.dumps({"kernels": [{
        "name": "roi_pool_gated",
        "route": "cuda",
        "source": "wsovod_torch/kernels/csrc/roi_pool_gated.cu",
        "replaces": "wsovod_tpu/ops/pallas/roi_pool_fused.py:1585",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
