"""Row-fold microbenchmark on the card: how fast a running max walks rows of
one resident map in float32, bfloat16 and int8 (kernel 2.9a, the
counterpart of ``scripts/bench_vpu_pack.py``, whose TPU kernel ``mk`` the
CUDA kernel ``wsovod_torch/kernels/csrc/row_fold.cu`` replaces).

    python -m wsovod_torch.scripts.bench_vpu_pack

``row_fold(feat)`` computes what ``mk`` computes: for each of ``steps``
grid steps and each pseudo-ROI ``r < n_roi``, the fold ``max(init, max over
h0 <= h < h0 + rows of feat[h, x0:x0+win, :])`` at ``h0 = (7r) mod (H -
rows)``, ``x0 = 8 ((13r) mod ((W - win) // 8))``, with ``init`` -3e38 in
the dtype or -127 for int8; every pseudo-ROI overwrites the step's output,
so the result ``[steps, win, C]`` is the last pseudo-ROI's fold, once per
step. A CPU tensor takes ``row_fold_plain``; a CUDA tensor launches the
kernel or raises. ``LAUNCHES`` counts the kernel's launches.

``main()`` makes the map as the JAX script does (normal x 10, cast to the
dtype; here from a seeded ``torch.Generator`` on the card), holds each
dtype's result against the plain version bit for bit, times 20 calls after
a warm-up with CUDA events, and prints the JAX script's line per dtype
(``f32 : ms (Gelem/s)``) with the walk's rate, the bound, the plain
version's time and the time at a quarter of the pseudo-ROIs, after the
card's name and power limit.
"""

from __future__ import annotations

import sys

import torch

from ..ops.roi_pool import _launch
from . import bound, card_line, check_equal, cuda_device, cuda_ms, timed

H, W, CT = 86, 136, 512  # the map, as in the JAX script
ROWS = 20  # rows folded per pseudo-ROI
NROI = 256  # pseudo-ROIs per grid step
WIN = 48  # columns of a window
STEPS = 8  # grid steps
REPS = 20  # timed calls, as the JAX script
SCRATCH_SLOTS = 4  # the kernel's scratch folds after the steps' outputs
DTYPES = (("f32 ", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8))
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}

LAUNCHES = 0


def init_value(dtype: torch.dtype) -> torch.Tensor:
    """The fold's start: -3e38 rounded to ``dtype``, or -127 for int8."""
    return torch.tensor(-127 if dtype == torch.int8 else -3e38, dtype=dtype)


def origins(n_roi: int, h: int, w: int, rows: int, win: int):
    """``(h0, x0)``, int64 ``[n_roi]``: each pseudo-ROI's first row and
    first column."""
    r = torch.arange(n_roi)
    return (7 * r) % (h - rows), 8 * ((13 * r) % ((w - win) // 8))


def _check(feat: torch.Tensor, n_roi: int, rows: int, win: int, steps: int) -> None:
    if feat.dim() != 3:
        raise ValueError(f"feat must be [H, W, C], got {tuple(feat.shape)}")
    if feat.dtype not in _SUFFIX:
        raise TypeError(f"row_fold takes float32, bfloat16 or int8, not {feat.dtype}")
    h, w, _ = feat.shape
    if min(n_roi, rows, win, steps) < 1 or h <= rows or (w - win) // 8 < 1:
        raise ValueError(f"row_fold needs H > rows, W - win >= 8 and n_roi, rows, win, steps "
                         f">= 1: H, W = {h}, {w}; n_roi {n_roi}, rows {rows}, win {win}, "
                         f"steps {steps}")


def row_fold(feat: torch.Tensor, *, n_roi: int = NROI, rows: int = ROWS, win: int = WIN,
             steps: int = STEPS) -> torch.Tensor:
    """``mk``'s fold of ``feat [H, W, C]`` (float32, bfloat16 or int8):
    ``[steps, win, C]`` in ``feat``'s dtype (see the module docstring). On
    the card the kernel folds every pseudo-ROI of every step."""
    global LAUNCHES
    _check(feat, n_roi, rows, win, steps)
    if feat.device.type == "cpu":
        return row_fold_plain(feat, n_roi=n_roi, rows=rows, win=win, steps=steps)
    if feat.device.type != "cuda":
        raise ValueError(f"row_fold runs on CPU or CUDA tensors, not {feat.device}")
    h, w, c = feat.shape
    if not feat.is_contiguous() or feat.data_ptr() % 16 or c * feat.element_size() % 16:
        raise ValueError("feat must be contiguous and 16-byte aligned, with C x its element "
                         "size a multiple of 16 bytes")
    out = torch.empty((steps + SCRATCH_SLOTS, win, c), dtype=feat.dtype, device=feat.device)
    _launch("row_fold.cu", f"wsovod_row_fold_{_SUFFIX[feat.dtype]}", None, [feat, out],
            [h, w, c, rows, win, n_roi, steps, SCRATCH_SLOTS], what="row_fold")
    LAUNCHES += 1
    return out[:steps]


def row_fold_plain(feat: torch.Tensor, *, n_roi: int = NROI, rows: int = ROWS, win: int = WIN,
                   steps: int = STEPS) -> torch.Tensor:
    """``row_fold`` in plain PyTorch: every pseudo-ROI's fold (one step's
    walk: every step walks the same), the last one repeated ``steps``
    times."""
    _check(feat, n_roi, rows, win, steps)
    h0, x0 = origins(n_roi, feat.shape[0], feat.shape[1], rows, win)
    dev = feat.device
    hs = (h0[:, None] + torch.arange(rows))[:, :, None].to(dev)  # [n_roi, rows, 1]
    xs = (x0[:, None] + torch.arange(win))[:, None, :].to(dev)  # [n_roi, 1, win]
    folds = torch.maximum(feat[hs, xs].amax(dim=1), init_value(feat.dtype).to(dev))
    return folds[-1].expand(steps, -1, -1).contiguous()


def make_map(dtype: torch.dtype, device, seed: int = 0, shape=(H, W, CT)) -> torch.Tensor:
    """The JAX script's map: normal x 10 cast to ``dtype`` (int8 truncated
    toward zero, as XLA's convert), from a ``torch.Generator`` seeded with
    ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * 10).to(dtype)


def measure(feat: torch.Tensor, n_roi: int = NROI, reps: int = REPS) -> dict:
    """``row_fold`` on a card tensor: its result held against the plain
    version bit for bit (raises otherwise); its ms over ``reps`` calls after
    a warm-up, the plain version's ms, the ms at ``n_roi // 4`` pseudo-ROIs
    and their ratio; compares, elements per second, the walk's GB/s (bytes of
    rows read) and the bound."""
    c = feat.shape[-1]
    got = row_fold(feat, n_roi=n_roi)
    want, plain_ms = timed(lambda: row_fold_plain(feat, n_roi=n_roi))
    check_equal(got, want, f"row_fold {feat.dtype}")
    ms = cuda_ms(lambda: row_fold(feat, n_roi=n_roi), reps)
    quarter_ms = cuda_ms(lambda: row_fold(feat, n_roi=n_roi // 4), reps)
    compares = STEPS * n_roi * ROWS * WIN * c
    out_bytes = STEPS * WIN * c * feat.element_size()
    bound_ms, bound_by = bound(compares, feat.numel() * feat.element_size(), out_bytes)
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": 0.0, "quarter_ms": quarter_ms,
            "quarter_ratio": quarter_ms / ms, "compares": compares,
            "gelem_per_s": compares / ms * 1e3 / 1e9,
            "walk_gb_per_s": compares * feat.element_size() / ms * 1e3 / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by}


def line(name: str, rec: dict) -> str:
    """The JAX script's line for one dtype, with the walk's rate, the
    bound, the plain version and the quarter count beside it."""
    return (f"{name}: {rec['ms']:.4f} ms  ({rec['gelem_per_s']:.1f} Gelem/s); walk "
            f"{rec['walk_gb_per_s']:.1f} GB/s of rows read; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}: {rec['compares'] / 1e9:.3f} G compares); plain "
            f"{rec['plain_ms']:.3f} ms, equal; n_roi / 4: {rec['quarter_ms']:.4f} ms "
            f"(ratio {rec['quarter_ratio']:.3f})")


def main() -> int:
    dev = cuda_device("bench_vpu_pack")
    if dev is None:
        return 2
    print(f"card: {card_line()}; row fold of [{H}, {W}, {CT}]: {STEPS} steps x {NROI} "
          f"pseudo-ROIs x {ROWS} rows x [{WIN}, {CT}]", flush=True)
    for name, dtype in DTYPES:
        print(line(name, measure(make_map(dtype, dev))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
