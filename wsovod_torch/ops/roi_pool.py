"""Gated exact max RoIPool and gated, branch-routed ROILoopPool: the CUDA
kernels' wrappers and their plain PyTorch versions (counterparts:
``wsovod_tpu/ops/roi_pool.py::roi_pool`` and ``::roi_loop_pool`` for the
semantics, ``wsovod_tpu/ops/pallas/roi_pool_fused.py::roi_pool_fused_batched``
with ``loop_pool=False``, and with ``loop_pool=True`` and ``src_tbl``, for the
TPU kernels they replace).

``roi_pool_gated(feat, rois, gate, c_base, c_take, output_size,
spatial_scale)`` returns, for every image ``b``,
``roi_pool(feat[b], rois[b], P, scale)[..., c_base:c_base+c_take] *
gate[b, :, None, None, None]`` as ``[B, N, P, P, c_take]`` in ``feat``'s
dtype, with the gate rounded to that dtype first (as the reference's
``pooled * gate.astype(pooled.dtype)``), so the kernel and the plain version
agree bit for bit in bfloat16 and float32.

``roi_loop_pool_gated(feat, rois, gate, src, c_base, c_take, rows,
output_size, spatial_scale, context_ratio)`` returns, for every image ``b``
and ROI ``n``, ``roi_loop_pool(feat[src[b, n]], rois[b], P, scale,
ratio)[r, n, ..., c_base:c_base+c_take] * gate[b, n]`` for ``r < rows`` as
``[rows, B, N, P, P, c_take]``: row 0 the ROI, row 1 the frame, row 2 the
context, each a max that starts at 0. ``src`` picks the feature copy each ROI
reads (MRRP: ``branch * B + b`` of the branch-major concat), so the ROIs
need no sorting by branch. The same rounding of the gate holds.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` and ``LOOP_LAUNCHES`` count the two kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30  # the reference's fill value for masked-out pixels

LAUNCHES = 0
LOOP_LAUNCHES = 0

_DTYPE_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _kernel(source: str, entry: str, dtype: torch.dtype, argtypes):
    """The C entry point ``<entry>_<dtype>`` of ``csrc/<source>``, with its
    ctypes signature (builds and loads the library at first use)."""
    from ..kernels import load

    fn = getattr(load(source), f"{entry}_{_DTYPE_SUFFIX[dtype]}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def round_region(rois: torch.Tensor, spatial_scale: float) -> torch.Tensor:
    """Rounded integer region ``(x1, y1, w, h)`` per ROI, int32 ``[..., 4]``.

    ``floor(x * scale + 0.5)`` (C ``round`` for the non-negative coordinates
    of this pipeline), taken as two separately rounded float32 ops like the
    reference; ``w, h = max(x2 - x1 + 1, 1)``."""
    r = torch.floor(rois.float() * spatial_scale + 0.5).to(torch.int32)
    x1, y1 = r[..., 0], r[..., 1]
    w = (r[..., 2] - x1 + 1).clamp(min=1)
    h = (r[..., 3] - y1 + 1).clamp(min=1)
    return torch.stack([x1, y1, w, h], dim=-1)


def _bin_edges(start: torch.Tensor, size: torch.Tensor, pooled: int, limit: int):
    """Integer bin edges ``[lo, hi)`` per bin: ``floor(p*size/P)`` and
    ``ceil((p+1)*size/P)`` plus ``start``, clipped to ``[0, limit]``.
    ``start``/``size`` ``[...]`` -> ``[..., P]``."""
    p = torch.arange(pooled, dtype=torch.int32, device=start.device)
    lo = torch.div(p * size[..., None], pooled, rounding_mode="floor") + start[..., None]
    hi = -torch.div(-(p + 1) * size[..., None], pooled, rounding_mode="floor") + start[..., None]
    return lo.clamp(0, limit), hi.clamp(0, limit)


def roi_pool_gated_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    max_elems: int = 1 << 27,
) -> torch.Tensor:
    """The plain PyTorch version: the reference's separable masked max (max
    over each bin's columns, then over its rows), in ROI chunks sized so the
    ``[n, P, H, W, c]`` masked temporary stays under ``max_elems``."""
    b, h_lim, w_lim, _ = feat.shape
    n, p = rois.shape[1], output_size
    f = feat[..., c_base : c_base + c_take]
    reg = round_region(rois, spatial_scale)
    hlo, hhi = _bin_edges(reg[..., 1], reg[..., 3], p, h_lim)  # [B, N, P]
    wlo, whi = _bin_edges(reg[..., 0], reg[..., 2], p, w_lim)
    hidx = torch.arange(h_lim, device=feat.device)
    widx = torch.arange(w_lim, device=feat.device)
    neg = torch.tensor(NEG_INF, dtype=feat.dtype, device=feat.device)
    g = gate.to(feat.dtype)
    step = max(1, max_elems // max(1, p * h_lim * w_lim * c_take))
    out = torch.empty((b, n, p, p, c_take), dtype=feat.dtype, device=feat.device)
    for i in range(b):
        fi = f[i]
        for s in range(0, n, step):
            e = min(n, s + step)
            row_in = (hidx >= hlo[i, s:e, :, None]) & (hidx < hhi[i, s:e, :, None])  # [n, P, H]
            col_in = (widx >= wlo[i, s:e, :, None]) & (widx < whi[i, s:e, :, None])  # [n, P, W]
            colmax = torch.where(col_in[:, :, None, :, None], fi[None, None], neg).amax(dim=3)
            pooled = torch.where(row_in[:, :, None, :, None], colmax[:, None], neg).amax(dim=3)
            pooled = torch.where(pooled <= neg, torch.zeros((), dtype=feat.dtype, device=feat.device), pooled)
            out[i, s:e] = pooled * g[i, s:e, None, None, None]
    return out


def _check(feat, rois, gate, c_base, c_take):
    if feat.dim() != 4:
        raise ValueError(f"feat must be [B, H, W, C], got {tuple(feat.shape)}")
    b, _, _, c = feat.shape
    if rois.shape != (b, rois.shape[1], 4):
        raise ValueError(f"rois must be [B, N, 4], got {tuple(rois.shape)}")
    if gate.shape != rois.shape[:2]:
        raise ValueError(f"gate must be [B, N], got {tuple(gate.shape)}")
    if not (0 <= c_base and c_take > 0 and c_base + c_take <= c):
        raise ValueError(f"channel chunk [{c_base}, {c_base + c_take}) outside C={c}")
    if not (rois.device == gate.device == feat.device):
        raise ValueError("feat, rois and gate must be on one device")


def roi_pool_gated(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
) -> torch.Tensor:
    """Gated pool of channels ``[c_base, c_base + c_take)``: ``feat [B, H, W,
    C]`` (NHWC, contiguous), ``rois [B, N, 4]`` XYXY image coordinates,
    ``gate [B, N]`` -> ``[B, N, P, P, c_take]``. The output keeps (ph, pw, c)
    innermost so fc1 reads a chunk as ``[B*N, P*P*c_take]`` with no copy."""
    global LAUNCHES
    _check(feat, rois, gate, c_base, c_take)
    if feat.device.type == "cpu":
        return roi_pool_gated_plain(feat, rois, gate, c_base, c_take, output_size, spatial_scale)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_pool_gated runs on CPU or CUDA tensors, not {feat.device}")
    if feat.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"roi_pool_gated kernel takes bfloat16 or float32, not {feat.dtype}")
    if not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("feat must be a contiguous, 16-byte aligned NHWC tensor")
    b, h, w, c = feat.shape
    if c % 2 or c_base % 2 or c_take % 2:
        raise ValueError("C, c_base and c_take must be even (two channels per thread)")
    n = rois.shape[1]
    region = round_region(rois, spatial_scale).contiguous()
    g = gate.to(feat.dtype).contiguous()
    out = torch.empty((b, n, output_size, output_size, c_take), dtype=feat.dtype, device=feat.device)
    neg_floor = float(torch.tensor(NEG_INF, dtype=feat.dtype))
    fn = _kernel("roi_pool_gated.cu", "wsovod_roi_pool_gated", feat.dtype,
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    # region and g are freed when this returns, while the kernel may still
    # run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(feat.data_ptr(), region.data_ptr(), g.data_ptr(), out.data_ptr(),
                b, h, w, c, n, int(c_base), int(c_take), int(output_size), neg_floor, stream)
    if rc != 0:
        raise RuntimeError(f"roi_pool_gated kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def _masked_max(f: torch.Tensor, row_in: torch.Tensor, col_in: torch.Tensor,
                neg: torch.Tensor) -> torch.Tensor:
    """max of ``f [H, W, c]`` over ``{(h, w): row_in & col_in}`` per (ROI,
    bin): ``row_in [n, P, H]``, ``col_in [n, P, W]`` -> ``[n, P, P, c]``
    (``neg`` where the set is empty); the reference's separable max."""
    colmax = torch.where(col_in[:, :, None, :, None], f[None, None], neg).amax(dim=3)
    return torch.where(row_in[:, :, None, :, None], colmax[:, None], neg).amax(dim=3)


def loop_geometry(rois: torch.Tensor, spatial_scale: float, h_lim: int, w_lim: int,
                  context_ratio: float) -> torch.Tensor:
    """The ROILoopPool's integer geometry per ROI, int32 ``[..., 16]``:

    * ``[0:4]`` the ROI's rounded region ``(x1, y1, w, h)`` (``round_region``);
    * ``[4:8]`` the same of the outer box (the ROI grown by
      ``context_ratio``, clipped to the image);
    * ``[8:12]`` the frame's hole ``floor(x * scale + 0.5)`` of the inner box
      (the ROI shrunk by ``context_ratio``, clipped), ``(x1, y1, x2, y2)``;
    * ``[12:16]`` the context's hole, the same of the unclipped ROI.

    A hole removes the pixels ``x1 < w < x2 and y1 < h < y2`` from its row's
    bins. Float32 throughout, one rounding per op, as
    ``wsovod_tpu/ops/roi_pool.py::roi_loop_pool``; the division by the ratio
    divides by a tensor, so that CPU and CUDA round it alike (a division by a
    Python number may become a multiplication by its reciprocal on CUDA)."""
    r = rois.float()
    x1, y1, x2, y2 = r.unbind(-1)
    rw, rh = x2 - x1, y2 - y1
    ratio = torch.full_like(rw, context_ratio)
    in_dw, in_dh = (rw - rw / ratio) / 2, (rh - rh / ratio) / 2
    out_dw, out_dh = (rw * ratio - rw) / 2, (rh * ratio - rh) / 2
    img_w, img_h = w_lim / spatial_scale, h_lim / spatial_scale

    def clipped(bx1, by1, bx2, by2):
        return torch.stack([bx1.clamp(0.0, img_w), by1.clamp(0.0, img_h),
                            bx2.clamp(0.0, img_w), by2.clamp(0.0, img_h)], dim=-1)

    inner = clipped(x1 + in_dw, y1 + in_dh, x2 - in_dw, y2 - in_dh)
    outer = clipped(x1 - out_dw, y1 - out_dh, x2 + out_dw, y2 + out_dh)

    def ints(box):
        return torch.floor(box * spatial_scale + 0.5).to(torch.int32)

    return torch.cat([round_region(r, spatial_scale), round_region(outer, spatial_scale),
                      ints(inner), ints(r)], dim=-1)


def roi_loop_pool_gated_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    src: torch.Tensor,
    c_base: int,
    c_take: int,
    rows: int = 3,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    context_ratio: float = 1.8,
    max_elems: int = 1 << 27,
) -> torch.Tensor:
    """The plain PyTorch version: per image and feature copy, the
    reference's separable masked maxes (the frame and the context as the max
    of two of them, one with the hole's columns and one with its rows taken
    out), in ROI chunks sized so the ``[n, P, H, W, c]`` temporary stays under
    ``max_elems``. Only the requested rows are computed."""
    _, h_lim, w_lim, _ = feat.shape
    b, n = rois.shape[:2]
    p = output_size
    f = feat[..., c_base : c_base + c_take]
    geo = loop_geometry(rois, spatial_scale, h_lim, w_lim, context_ratio)
    hidx = torch.arange(h_lim, device=feat.device)
    widx = torch.arange(w_lim, device=feat.device)
    neg = torch.tensor(NEG_INF, dtype=feat.dtype, device=feat.device)
    g = gate.to(feat.dtype)
    step = max(1, max_elems // max(1, p * h_lim * w_lim * c_take))
    out = torch.empty((rows, b, n, p, p, c_take), dtype=feat.dtype, device=feat.device)

    def bins(region):  # (x1, y1, w, h) [m, 4] -> row_in [m, P, H], col_in [m, P, W]
        hlo, hhi = _bin_edges(region[:, 1], region[:, 3], p, h_lim)
        wlo, whi = _bin_edges(region[:, 0], region[:, 2], p, w_lim)
        return ((hidx >= hlo[..., None]) & (hidx < hhi[..., None]),
                (widx >= wlo[..., None]) & (widx < whi[..., None]))

    def hollow(fs, row_in, col_in, hole):  # bin pixels outside the hole's strict interior
        col_ok = (widx <= hole[:, 0, None]) | (widx >= hole[:, 2, None])  # [m, W]
        row_ok = (hidx <= hole[:, 1, None]) | (hidx >= hole[:, 3, None])  # [m, H]
        return torch.maximum(_masked_max(fs, row_in, col_in & col_ok[:, None], neg),
                             _masked_max(fs, row_in & row_ok[:, None], col_in, neg))

    for i in range(b):
        for s in torch.unique(src[i]).tolist():
            idx = torch.nonzero(src[i] == s).squeeze(1)
            fs = f[s]
            for lo in range(0, idx.numel(), step):
                sel = idx[lo : lo + step]
                m = geo[i, sel]
                row_roi, col_roi = bins(m[:, 0:4])
                pooled = [_masked_max(fs, row_roi, col_roi, neg)]
                if rows > 1:
                    pooled.append(hollow(fs, row_roi, col_roi, m[:, 8:12]))
                if rows > 2:
                    row_out, col_out = bins(m[:, 4:8])
                    pooled.append(hollow(fs, row_out, col_out, m[:, 12:16]))
                gi = g[i, sel, None, None, None]
                for r, pr in enumerate(pooled):
                    out[r, i, sel] = pr.clamp_min(0) * gi
    return out


def roi_loop_pool_gated(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    src: torch.Tensor,
    c_base: int,
    c_take: int,
    rows: int = 3,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    context_ratio: float = 1.8,
) -> torch.Tensor:
    """Gated ROILoopPool of channels ``[c_base, c_base + c_take)``: ``feat
    [S, H, W, C]`` (NHWC, contiguous; S feature copies), ``rois [B, N, 4]``
    XYXY image coordinates, ``gate [B, N]``, ``src [B, N]`` integer copy
    index in ``[0, S)`` -> ``[rows, B, N, P, P, c_take]``; row 0 is a ``[B*N,
    P*P*c_take]`` fc1 operand with no copy. On the card ``src``'s range is
    checked by a device-side assert, which needs no synchronisation."""
    global LOOP_LAUNCHES
    if feat.dim() != 4:
        raise ValueError(f"feat must be [S, H, W, C], got {tuple(feat.shape)}")
    b, n = rois.shape[:2]
    if rois.shape != (b, n, 4) or gate.shape != (b, n) or src.shape != (b, n):
        raise ValueError(f"rois [B, N, 4], gate and src [B, N]: got {tuple(rois.shape)}, "
                         f"{tuple(gate.shape)}, {tuple(src.shape)}")
    if src.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"src must be an integer tensor, not {src.dtype}")
    if not (0 <= c_base and c_take > 0 and c_base + c_take <= feat.shape[3]):
        raise ValueError(f"channel chunk [{c_base}, {c_base + c_take}) outside C={feat.shape[3]}")
    if rows not in (1, 2, 3):
        raise ValueError(f"rows must be 1, 2 or 3, not {rows}")
    if not (rois.device == gate.device == src.device == feat.device):
        raise ValueError("feat, rois, gate and src must be on one device")
    if feat.device.type == "cpu":
        if src.numel() and not (0 <= int(src.min()) and int(src.max()) < feat.shape[0]):
            raise ValueError(f"src must lie in [0, {feat.shape[0]})")
        return roi_loop_pool_gated_plain(feat, rois, gate, src, c_base, c_take, rows,
                                         output_size, spatial_scale, context_ratio)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_loop_pool_gated runs on CPU or CUDA tensors, not {feat.device}")
    if feat.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"roi_loop_pool_gated kernel takes bfloat16 or float32, not {feat.dtype}")
    if not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("feat must be a contiguous, 16-byte aligned NHWC tensor")
    _, h, w, c = feat.shape
    if c % 2 or c_base % 2 or c_take % 2:
        raise ValueError("C, c_base and c_take must be even (two channels per thread)")
    geo = loop_geometry(rois, spatial_scale, h, w, context_ratio).contiguous()
    src32 = src.to(torch.int32).contiguous()
    torch._assert_async(((src32 >= 0) & (src32 < feat.shape[0])).all())
    g = gate.to(feat.dtype).contiguous()
    out = torch.empty((rows, b, n, output_size, output_size, c_take), dtype=feat.dtype,
                      device=feat.device)
    fn = _kernel("roi_loop_pool_gated.cu", "wsovod_roi_loop_pool_gated", feat.dtype,
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    # geo, src32 and g are freed when this returns, while the kernel may
    # still run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(feat.data_ptr(), geo.data_ptr(), src32.data_ptr(), g.data_ptr(), out.data_ptr(),
                b, h, w, c, n, int(c_base), int(c_take), int(output_size), int(rows), stream)
    if rc != 0:
        raise RuntimeError(f"roi_loop_pool_gated kernel launch failed: cudaError {rc}")
    LOOP_LAUNCHES += 1
    return out
