"""Gated, branch-routed ROIAlign: the CUDA kernels' wrappers and their plain
PyTorch versions (counterparts: ``wsovod_tpu/ops/roi_pool.py::roi_align`` for
the semantics; ``wsovod_tpu/ops/pallas/roi_align_fused.py::
roi_align_fused_batched`` and ``roi_align_fused_ad``, and
``wsovod_tpu/ops/pallas/roi_align_kernel.py::roi_align_pallas_exact`` and
``roi_align_pallas``, for the TPU kernels they replace).

``roi_align_gated(feat, rois, gate, c_base, c_take, output_size,
spatial_scale, sampling_ratio, aligned, src, window)`` returns, for every
image ``b`` and ROI ``n``, ``roi_align(feat[src[b, n]], rois[b], P, scale,
sampling_ratio, aligned)[n, ..., c_base:c_base+c_take] * gate[b, n]`` as
``[B, N, P, P, c_take]`` in ``feat``'s dtype: ``s = max(sampling_ratio, 1)``
samples per bin axis at ``y1 + (ph + (sy + 0.5) / s) * bin_h`` (offset 0.5
when ``aligned``; the ROI's size floored at 1 only when not), each the
bilinear blend of its four neighbours, a sample outside ``[-1, limit]``
counting 0, the ``s * s`` samples summed and divided by ``s * s``. Without
``src`` ROI ``n`` of image ``b`` reads ``feat[b]``; with it, copy ``branch *
B + b`` of MRRP's branch-major concat, as the JAX package pools every branch
copy and keeps each ROI's (``wsovod_tpu/models/poolers.py:805-841``).

Rounding: the bilinear weights and the sums are float32, and the result is
rounded once to ``feat``'s dtype after the gate (a float32 scalar) scales
it, as the TPU kernels do ("bit-comparable to the gather path modulo f32
summation order", ``roi_align_fused.py:29-30``). The JAX package's jnp
gather path in bfloat16 rounds at every step instead (the weights, each
product, each partial sum), so in bfloat16 the two differ by up to a few
bfloat16 steps; in float32 they agree to summation order.

``window`` (``None``, or the requested window size, 32 for
``TPU.ROI_ALIGN_KERNEL = "pallas_approx"``) reproduces the numbers of the
windowed TPU kernel ``roi_align_pallas`` (``roi_align_kernel.py:89-99,
161-177, 31-44``): each ROI reads a window of ``win_y x win_x`` pixels whose
origin is ``floor(y1)`` and ``floor(x1)`` aligned down to 8, clipped to the
map; a ROI longer than its window (and whose window stops short of the
map's edge) has its sample grid resampled into it by ``min(1, span /
extent)`` per axis, and the corner indices are then clamped to the window.
It changes the sample metadata only, not the gather.

The plain version makes the sample metadata (two corner indices and two
weights per sample row and column, ``sample_meta``) in PyTorch, in the
reference's float32 order of operations; the kernels take the ROIs, the
scale, ``aligned`` and the window, and each block builds its ROI's metadata
in shared memory in the same order (``kernels/csrc/roi_align_common.cuh``),
so the card holds the kernel's arithmetic against an independent path.

``RoIAlignGatedFunction`` makes ``roi_align_gated`` differentiable (the
counterpart of ``roi_align_fused_ad`` and ``roi_align_pallas_exact_ad``):
its backward ``roi_align_gated_bwd`` spreads ``gate * g / s**2`` over each
in-range sample's four corners by their bilinear weights, added with
float32 atomics into a float32 scratch that spans every source copy, and
takes the gate cotangent ``sum(g * out) / gate`` where ``|gate| > 1e-8``
(``_fused_ad_bwd``). The windowed mode has no backward: the TPU kernel it
reproduces has no VJP in the JAX package.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` and ``BWD_LAUNCHES`` count the two kernels' launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .roi_pool import (_check, _check_c_tile, _check_kernel_args, _gate_cotangent, _kernel,
                       _launch, _ptr, _src32, quant_scale, quantize_tiles)

LAUNCHES = 0
BWD_LAUNCHES = 0
INT8_LAUNCHES = 0

WINDOW = 32  # roi_align_pallas's default window, TPU.ROI_ALIGN_KERNEL = "pallas_approx"


def samples_per_axis(sampling_ratio: int) -> int:
    return max(int(sampling_ratio), 1)


def _axis(coord: torch.Tensor, limit: int, window=None):
    """Corner indices ``[..., K, 2]`` (int32, lo and hi) and weights
    ``[..., K, 2]`` (float32, zero where the sample is out of range) of
    sample coordinates ``coord [..., K]`` along an axis of ``limit`` pixels;
    ``window (origin [...], size)`` clamps the indices into it."""
    ok = ((coord >= -1.0) & (coord <= float(limit))).float()
    c = coord.clamp(0.0, float(limit - 1))
    lo = torch.floor(c)
    hi = torch.minimum(lo + 1.0, torch.full_like(lo, float(limit - 1)))
    w_hi = c - lo
    w_lo = 1.0 - w_hi
    idx = torch.stack([lo, hi], dim=-1).to(torch.int32)
    if window is not None:
        origin, size = window
        origin = origin[..., None, None]
        idx = origin + (idx - origin).clamp(0, size - 1)
    return idx, torch.stack([w_lo * ok, w_hi * ok], dim=-1)


def window_geometry(h: int, w: int, window: int) -> Tuple[int, int, int]:
    """``(win_y, win_x, w8)`` of ``roi_align_pallas``'s window on an ``[h,
    w]`` map: ``win = min(window, h, max(w - 8, 8))``, ``win_y = min(win + 8,
    h)``, ``win_x = win + 8``; ``w8`` is ``w`` rounded up to 8."""
    win = min(window, h, max(w - 8, 8))
    return min(win + 8, h), win + 8, -(-w // 8) * 8


def sample_meta(rois: torch.Tensor, spatial_scale: float, output_size: int, sampling_ratio: int,
                aligned: bool, h: int, w: int, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(idx int32 [..., 2, K, 2], wt float32 [..., 2, K, 2])`` for ROIs
    ``[..., 4]`` on an ``[h, w]`` map, ``K = P * s``: along axis 0 (y) and 1
    (x), per sample ``k = p * s + sub``, the lo and hi corner index and
    weight, the sample's range test folded into the weights. Float32, one
    rounding per op in the reference's order as XLA compiles it: its
    algebraic simplifier turns the division by the constant ``P`` into a
    multiplication by the float32 reciprocal, which moves a sample by an
    ulp, enough to cross a pixel edge or the range test (the constants are
    tensors, so that CPU and CUDA round alike)."""
    p, s = output_size, samples_per_axis(sampling_ratio)
    r = rois.float() * spatial_scale - (0.5 if aligned else 0.0)
    x1, y1, x2, y2 = r.unbind(-1)
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
    bin_w = rw * torch.full_like(rw, 1.0 / p)
    bin_h = rh * torch.full_like(rh, 1.0 / p)
    sub = torch.tensor([(sy + 0.5) / s for sy in range(s)], dtype=torch.float32,
                       device=rois.device)
    grid = (torch.arange(p, dtype=torch.float32, device=rois.device)[:, None] + sub).reshape(-1)
    ys = y1[..., None] + grid * bin_h[..., None]
    xs = x1[..., None] + grid * bin_w[..., None]
    win_y = win_x = None
    if window is not None:
        win_y, win_x, w8 = window_geometry(h, w, window)
        y0 = torch.floor(y1).to(torch.int32).clamp(0, max(h - win_y, 0))
        x0 = torch.floor(x1).to(torch.int32).clamp(0, max(w8 - win_x, 0))
        x0 = torch.div(x0, 8, rounding_mode="floor") * 8
        big = torch.full_like(y1, 1e9)
        span_y = torch.where(y0 + win_y >= h, big, (y0 + win_y - 2).float() - y1)
        span_x = torch.where(x0 + win_x >= w, big, (x0 + win_x - 2).float() - x1)
        one = torch.ones_like(y1)
        fy = torch.minimum(one, span_y / torch.maximum(y2 - y1, torch.full_like(y1, 1e-6)))
        fx = torch.minimum(one, span_x / torch.maximum(x2 - x1, torch.full_like(x1, 1e-6)))
        ys = y1[..., None] + (ys - y1[..., None]) * fy[..., None]
        xs = x1[..., None] + (xs - x1[..., None]) * fx[..., None]
    yi, yw = _axis(ys, h, None if window is None else (y0, win_y))
    xi, xw = _axis(xs, w, None if window is None else (x0, win_x))
    return torch.stack([yi, xi], dim=-3), torch.stack([yw, xw], dim=-3)


def _copies(src: Optional[torch.Tensor], b: int, n: int, device) -> torch.Tensor:
    """The feature copy of every ROI, ``[B * N]``: ``src``, or the image."""
    if src is not None:
        return src.reshape(-1).long()
    return torch.arange(b, device=device).repeat_interleave(n)


def _align_plain(f: torch.Tensor, idx: torch.Tensor, wt: torch.Tensor, copies: torch.Tensor,
                 p: int, s: int, normalise: bool = True) -> torch.Tensor:
    """Ungated ROIAlign sums divided by ``s * s`` (the raw sums without
    ``normalise``), float32, of ``f [S, H, W, c]`` (float32) for ``m`` ROIs
    of metadata ``idx``/``wt [m, 2, K, 2]`` reading copies ``copies [m]``:
    ``[m, P, P, c]``. The sample loop, the corner order and the sums follow
    ``wsovod_tpu/ops/roi_pool.py::_roi_align_impl``, whose division by ``s *
    s`` XLA makes a multiplication by the float32 reciprocal."""
    _, h, w, c = f.shape
    flat = f.reshape(-1, c)
    base = (copies * (h * w))[:, None, None]
    acc = torch.zeros((idx.shape[0], p, p, c), dtype=torch.float32, device=f.device)
    for sy in range(s):
        yi, yw = idx[:, 0, sy::s], wt[:, 0, sy::s]  # [m, P, 2]
        for sx in range(s):
            xi, xw = idx[:, 1, sx::s], wt[:, 1, sx::s]
            val = None
            for a in range(2):
                for e in range(2):
                    at = base + yi[:, :, None, a] * w + xi[:, None, :, e]  # [m, P, P]
                    term = flat[at] * (yw[:, :, None, a] * xw[:, None, :, e])[..., None]
                    val = term if val is None else val + term
            acc = acc + val
    if not normalise:
        return acc
    return acc * torch.full((), 1.0 / (s * s), dtype=torch.float32, device=f.device)


def roi_align_gated_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
    src: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    max_elems: int = 1 << 26,
) -> torch.Tensor:
    """The plain PyTorch version: the reference's sample loop on the
    chunk in float32, in ROI groups sized so each ``[m, P, P, c]``
    temporary stays under ``max_elems``; times the float32 gate, rounded
    once to ``feat``'s dtype."""
    _, h, w, _ = feat.shape
    b, n = rois.shape[:2]
    p, s = output_size, samples_per_axis(sampling_ratio)
    f = feat[..., c_base : c_base + c_take].float()
    idx, wt = sample_meta(rois, spatial_scale, p, sampling_ratio, aligned, h, w, window)
    idx, wt = idx.reshape(b * n, *idx.shape[2:]), wt.reshape(b * n, *wt.shape[2:])
    copies = _copies(src, b, n, feat.device)
    g = gate.float().reshape(-1)
    step = max(1, max_elems // max(1, p * p * c_take))
    out = torch.empty((b * n, p, p, c_take), dtype=feat.dtype, device=feat.device)
    for lo in range(0, b * n, step):
        sl = slice(lo, min(b * n, lo + step))
        pooled = _align_plain(f, idx[sl], wt[sl], copies[sl], p, s)
        out[sl] = (pooled * g[sl, None, None, None]).to(feat.dtype)
    return out.reshape(b, n, p, p, c_take)


def roi_align_gated(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
    src: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Gated ROIAlign of channels ``[c_base, c_base + c_take)``: ``feat [S,
    H, W, C]`` (NHWC, contiguous), ``rois [B, N, 4]`` XYXY image
    coordinates, ``gate [B, N]``, ``src [B, N]`` (integer copy index in
    ``[0, S)``, or ``None``: copy ``b``, S = B) -> ``[B, N, P, P, c_take]``,
    a ``[B*N, P*P*c_take]`` fc1 operand with no copy. ``window`` as in the
    module docstring. On the card ``src``'s range is checked by a
    device-side assert."""
    global LAUNCHES
    _check(feat, rois, gate, c_base, c_take, src)
    if feat.device.type == "cpu":
        return roi_align_gated_plain(feat, rois, gate, c_base, c_take, output_size, spatial_scale,
                                     sampling_ratio, aligned, src, window)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_align_gated runs on CPU or CUDA tensors, not {feat.device}")
    _check_kernel_args(feat, c_base, c_take, "roi_align_gated")
    s_copies, h, w, c = feat.shape
    b, n = rois.shape[:2]
    r32 = rois.float().contiguous()
    src32 = None if src is None else _src32(src, s_copies)
    g = gate.float().contiguous()
    out = torch.empty((b, n, output_size, output_size, c_take), dtype=feat.dtype,
                      device=feat.device)
    fn = _kernel("roi_align_gated.cu", "wsovod_roi_align_gated", feat.dtype,
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p])
    # r32, src32 and g are freed when this returns, while the kernel may
    # still run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(feat.data_ptr(), r32.data_ptr(), _ptr(src32), g.data_ptr(), out.data_ptr(), b, h,
                w, c, n, int(c_base), int(c_take), int(output_size),
                samples_per_axis(sampling_ratio), int(bool(aligned)), int(window or 0),
                float(spatial_scale), stream)
    if rc != 0:
        raise RuntimeError(f"roi_align_gated kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def roi_align_gated_int8_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    c_base: int,
    c_take: int,
    c_tile: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
    src: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    max_elems: int = 1 << 26,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the int8 emission: ``quantize_tiles`` of the
    raw float32 sample sums (before ``1 / s**2`` and the gate), and the
    scales ``((gate * (1 / s**2)) * m) * (1 / 127)`` ``[B, c_take /
    c_tile, N]``."""
    _, h, w, _ = feat.shape
    b, n = rois.shape[:2]
    p, s = output_size, samples_per_axis(sampling_ratio)
    f = feat[..., c_base : c_base + c_take].float()
    idx, wt = sample_meta(rois, spatial_scale, p, sampling_ratio, aligned, h, w, window)
    idx, wt = idx.reshape(b * n, *idx.shape[2:]), wt.reshape(b * n, *wt.shape[2:])
    copies = _copies(src, b, n, feat.device)
    step = max(1, max_elems // max(1, p * p * c_take))
    q = torch.empty((b * n, p, p, c_take), dtype=torch.int8, device=feat.device)
    m = torch.empty((b * n, c_take // c_tile), dtype=torch.float32, device=feat.device)
    for lo in range(0, b * n, step):
        sl = slice(lo, min(b * n, lo + step))
        q[sl], m[sl] = quantize_tiles(_align_plain(f, idx[sl], wt[sl], copies[sl], p, s, False),
                                      c_tile)
    scale_out = gate.float() * torch.full((), 1.0 / (s * s), dtype=torch.float32,
                                          device=feat.device)
    scales = quant_scale(scale_out[..., None], m.reshape(b, n, -1))
    return q.reshape(b, n, p, p, c_take), scales.permute(0, 2, 1).contiguous()


def roi_align_gated_int8(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    c_base: int,
    c_take: int,
    c_tile: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
    src: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The align's int8 emission (``roi_align_fused_batched(...,
    quant="int8")``, ``roi_align_fused.py:192-205``): ``(payload int8 [B, N,
    P, P, c_take], scales [B, c_take / c_tile, N] float32)``, per (ROI,
    ``c_tile``) the max ``m`` of the raw float32 sample sums, the payload
    ``round(acc * (127 / m))`` and the scale with the gate and ``1 / s**2``
    folded in. The kernel sums in the plain version's order without FMAs, so
    the two agree bit for bit. No pooler path reaches it: the JAX pooler
    emits the align in the feature dtype and fc1 quantizes."""
    global INT8_LAUNCHES
    _check(feat, rois, gate, c_base, c_take, src)
    _check_c_tile(c_take, c_tile)
    if feat.device.type == "cpu":
        return roi_align_gated_int8_plain(feat, rois, gate, c_base, c_take, c_tile, output_size,
                                          spatial_scale, sampling_ratio, aligned, src, window)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_align_gated_int8 runs on CPU or CUDA tensors, not {feat.device}")
    _check_kernel_args(feat, c_base, c_take, "roi_align_gated_int8")
    s_copies, h, w, c = feat.shape
    b, n = rois.shape[:2]
    out = torch.empty((b, n, output_size, output_size, c_take), dtype=torch.int8,
                      device=feat.device)
    scales = torch.empty((b, c_take // c_tile, n), dtype=torch.float32, device=feat.device)
    _launch("roi_align_gated.cu", "wsovod_roi_align_gated_int8", feat.dtype,
            [feat, rois.float().contiguous(), None if src is None else _src32(src, s_copies),
             gate.float().contiguous(), out, scales],
            [b, h, w, c, n, c_base, c_take, c_tile, output_size, samples_per_axis(sampling_ratio),
             int(bool(aligned)), int(window or 0)], [spatial_scale], "roi_align_gated_int8")
    INT8_LAUNCHES += 1
    return out, scales


def roi_align_gated_bwd_plain(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    out: Optional[torch.Tensor],
    g: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
    need_feat: bool = True,
    need_gate: bool = True,
    src: Optional[torch.Tensor] = None,
    max_elems: int = 1 << 26,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The plain PyTorch version of ``_fused_ad_bwd``
    (``wsovod_tpu/ops/pallas/roi_align_fused.py:453``) and, with ``src``, of
    the VJP of the JAX package's MRRP align (``_ra_exact_bwd`` per copy,
    ``roi_align_kernel.py:644``, through the branch select): ``(g_feat [S,
    H, W, C] in feat's dtype, zero outside the chunk and on copies no ROI
    reads, g_gate [B, N] in gate's dtype)``, each ``None`` where not wanted.

    ``g_gate`` is ``sum(g * out) / gate`` where ``|gate| > 1e-8``, else 0
    (``out`` the forward's output). ``g_feat`` is autograd through the
    plain forward's float32 arithmetic, gate included, in ROI groups sized
    by ``max_elems``, summed in float32 and rounded once to feat's dtype."""
    g_gate = _gate_cotangent(g, out, gate, (2, 3, 4)) if need_gate else None
    if not need_feat:
        return None, g_gate
    _, h, w, _ = feat.shape
    b, n = rois.shape[:2]
    p, s = output_size, samples_per_axis(sampling_ratio)
    idx, wt = sample_meta(rois, spatial_scale, p, sampling_ratio, aligned, h, w)
    idx, wt = idx.reshape(b * n, *idx.shape[2:]), wt.reshape(b * n, *wt.shape[2:])
    copies = _copies(src, b, n, feat.device)
    gf = gate.float().reshape(-1)
    gg = g.float().reshape(b * n, p, p, c_take)
    step = max(1, max_elems // max(1, p * p * c_take))
    leaf = feat[..., c_base : c_base + c_take].float().requires_grad_(True)
    acc = torch.zeros_like(leaf)
    for lo in range(0, b * n, step):
        sl = slice(lo, min(b * n, lo + step))
        with torch.enable_grad():
            pooled = _align_plain(leaf, idx[sl], wt[sl], copies[sl], p, s)
            (grad,) = torch.autograd.grad(pooled * gf[sl, None, None, None], leaf, gg[sl])
        acc += grad
    g_feat = torch.zeros_like(feat)
    g_feat[..., c_base : c_base + c_take] = acc.to(feat.dtype)
    return g_feat, g_gate


def roi_align_gated_bwd(
    feat: torch.Tensor,
    rois: torch.Tensor,
    gate: torch.Tensor,
    out: Optional[torch.Tensor],
    g: torch.Tensor,
    c_base: int,
    c_take: int,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
    need_feat: bool = True,
    need_gate: bool = True,
    src: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Backward of ``roi_align_gated`` at cotangent ``g [B, N, P, P,
    c_take]``: ``(g_feat [S, H, W, C], g_gate [B, N])`` as
    ``roi_align_gated_bwd_plain``; ``out`` (the forward's output) is read
    only for ``g_gate``. On the card the feature cotangent is summed with
    float32 atomics over every copy, so it equals the plain version to float
    tolerance, not bit for bit."""
    global BWD_LAUNCHES
    _check(feat, rois, gate, c_base, c_take, src)
    b, n = rois.shape[:2]
    shape = (b, n, output_size, output_size, c_take)
    if tuple(g.shape) != shape or (need_gate and (out is None or tuple(out.shape) != shape)):
        raise ValueError(f"g (and out for the gate cotangent) must be {shape}, got "
                         f"{tuple(g.shape)}, {None if out is None else tuple(out.shape)}")
    if feat.device.type == "cpu":
        return roi_align_gated_bwd_plain(feat, rois, gate, out, g, c_base, c_take, output_size,
                                         spatial_scale, sampling_ratio, aligned, need_feat,
                                         need_gate, src)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_align_gated_bwd runs on CPU or CUDA tensors, not {feat.device}")
    _check_kernel_args(feat, c_base, c_take, "roi_align_gated_bwd")
    s_copies, h, w, _ = feat.shape
    r32 = rois.float().contiguous()
    src32 = None if src is None else _src32(src, s_copies)
    gate_f32 = gate.float().contiguous()
    g = g.to(feat.dtype).contiguous()
    out = out.to(feat.dtype).contiguous() if need_gate else None
    scratch = (torch.zeros((s_copies, h, w, c_take), dtype=torch.float32, device=feat.device)
               if need_feat else None)
    g_gate = torch.empty((b, n), dtype=torch.float32, device=feat.device) if need_gate else None
    fn = _kernel("roi_align_gated_bwd.cu", "wsovod_roi_align_gated_bwd", feat.dtype,
                 [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    # the temporaries are freed when this returns, while the kernel may still
    # run: the caching allocator reuses their memory only in stream order
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(r32.data_ptr(), _ptr(src32), gate_f32.data_ptr(), g.data_ptr(), _ptr(out),
                _ptr(scratch), _ptr(g_gate), b, h, w, n, int(c_take), int(output_size),
                samples_per_axis(sampling_ratio), int(bool(aligned)), float(spatial_scale),
                stream)
    if rc != 0:
        raise RuntimeError(f"roi_align_gated_bwd kernel launch failed: cudaError {rc}")
    BWD_LAUNCHES += 1
    g_feat = None
    if need_feat:
        g_feat = torch.zeros_like(feat)
        g_feat[..., c_base : c_base + c_take] = scratch.to(feat.dtype)
    return g_feat, (g_gate.to(gate.dtype) if need_gate else None)


class RoIAlignGatedFunction(torch.autograd.Function):
    """``roi_align_gated`` under autograd (``roi_align_fused_ad``, and with
    ``src`` the JAX package's per-copy ``roi_align_pallas_exact_ad`` and
    branch select): the forward launches the align kernel, the backward
    ``roi_align_gated_bwd``. It saves nothing when neither ``feat`` nor
    ``gate`` needs a gradient (a frozen backbone and a validity gate, every
    shipped config), and the forward's output only when the gate needs one.
    The windowed mode refuses a feature that needs a gradient: its TPU
    kernel has no VJP."""

    @staticmethod
    def forward(ctx, feat, rois, gate, c_base, c_take, output_size, spatial_scale,
                sampling_ratio, aligned, src=None, window=None):
        need_feat, need_gate = ctx.needs_input_grad[0], ctx.needs_input_grad[2]
        if window is not None and need_feat:
            raise NotImplementedError("the windowed ROIAlign (TPU.ROI_ALIGN_KERNEL = "
                                      "'pallas_approx') has no backward for the feature")
        out = roi_align_gated(feat, rois, gate, c_base, c_take, output_size, spatial_scale,
                              sampling_ratio, aligned, src, window)
        if need_feat or need_gate:
            ctx.save_for_backward(feat, rois, gate, src, out if need_gate else None)
            ctx.args = (c_base, c_take, output_size, spatial_scale, sampling_ratio, aligned)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, rois, gate, src, out = ctx.saved_tensors
        g_feat, g_gate = roi_align_gated_bwd(feat, rois, gate, out, g, *ctx.args,
                                             need_feat=ctx.needs_input_grad[0],
                                             need_gate=ctx.needs_input_grad[2], src=src)
        return g_feat, None, g_gate, None, None, None, None, None, None, None, None
