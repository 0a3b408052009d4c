"""Bin row-walk microbenchmark on the card: a stage-A row walk of ROI bins
over one resident map, from bfloat16 or from int8 widened to bfloat16 on
load, over the full row or a 48- or 96-wide window (kernel 2.9b, the
counterpart of ``scripts/bench_i8walk.py``, whose TPU kernel ``build`` the
CUDA kernel ``wsovod_torch/kernels/csrc/row_walk.cu`` replaces).

    python -m wsovod_torch.scripts.bench_i8walk

``row_walk(feat, hlo, x0, win)`` computes what ``build`` computes: for ROI
``q`` and bin ``ph < bins``, ``k = q * bins + ph``, the bin ``max(bf16(-3e38),
max over t < ROWS of bf16(feat[0, hlo[k] + t, x0[k]:x0[k] + win]))``, or over
the full row when ``win`` is None; every bin overwrites its slot of one
output shared by all ROIs, so the result ``[bins, wd, C]`` bfloat16 holds
the last ROI's bins. A CPU tensor takes ``row_walk_plain``; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts the kernel's launches.

``main()`` makes the JAX script's inputs (numpy ``RandomState(0)``: the map,
int8 as ``clip(x * 16, -127, 127)``, the rows, then each case's 8-aligned
columns), holds each case's result against the plain version bit for bit,
times 10 calls after a warm-up with CUDA events, and prints the JAX script's
line per case (``ms (ns/row)``) with the walk's rate, the bound, the plain
version's time and the time at a quarter of the ROIs, after the card's name
and power limit.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..ops.roi_pool import _launch
from . import bound, card_line, check_equal, cuda_device, cuda_ms, timed

H, W, CT = 86, 136, 512  # the map, as in the JAX script
P, RB = 7, 8  # bins per ROI, ROIs per grid step
NB = 628  # grid steps: 5024 ROIs
ROWS = 3  # rows folded per bin
REPS = 10  # timed calls, as the JAX script
SCRATCH_SLOTS = 2  # the kernel's scratch copies of the output
CASES = (
    ("A bf16 fullrow", "bf16", None),
    ("B int8 fullrow", "int8", None),
    ("C bf16 win48  ", "bf16", 48),
    ("D int8 win48  ", "int8", 48),
    ("E int8 win96  ", "int8", 96),
    ("F bf16 win96  ", "bf16", 96),
)
_SUFFIX = {torch.bfloat16: "bf16", torch.int8: "i8"}
MAX_ELEMS = 1 << 27  # the plain version's gathered elements per chunk of bins

LAUNCHES = 0


def _check(feat, hlo, x0, win, bins) -> int:
    """Validate the arguments; return the bin width ``wd``."""
    if feat.dim() != 4 or feat.shape[0] != 1:
        raise ValueError(f"feat must be [1, H, W, C], got {tuple(feat.shape)}")
    if feat.dtype not in _SUFFIX:
        raise TypeError(f"row_walk takes bfloat16 or int8, not {feat.dtype}")
    _, h, w, _ = feat.shape
    wd = w if win is None else win
    for name, t in (("hlo", hlo), ("x0", x0)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be int32 [n_roi * bins], got {t.dtype} "
                            f"{tuple(t.shape)}")
    if hlo.shape != x0.shape or hlo.numel() % (bins * RB) or hlo.numel() == 0:
        raise ValueError(f"hlo and x0 must hold whole grid steps of {RB} ROIs x "
                         f"{bins} bins: got {hlo.numel()} and {x0.numel()}")
    if not ROWS < h or not 1 <= wd <= w:
        raise ValueError(f"rows {ROWS} and window {wd} must fit the {h} x {w} map")
    if hlo.device != feat.device or x0.device != feat.device:
        raise ValueError("feat, hlo and x0 must be on one device")
    return wd


def row_walk(feat: torch.Tensor, hlo: torch.Tensor, x0: torch.Tensor, win: Optional[int], *,
             bins: int = P) -> torch.Tensor:
    """``build``'s walk of ``feat [1, H, W, C]`` (bfloat16, or int8 widened
    to bfloat16) at rows ``hlo`` and columns ``x0`` (int32 ``[n_roi *
    bins]``, ``n_roi`` a multiple of ``RB``; each hlo in ``[0, H -
    ROWS]``, each x0 in ``[0, W - win]``, unread when ``win`` is None, the
    full row): ``[bins, wd, C]`` bfloat16 (see the module docstring). On the
    card the kernel walks every ROI's bins, and a device-side assert checks
    the rows' and columns' ranges."""
    global LAUNCHES
    wd = _check(feat, hlo, x0, win, bins)
    if feat.device.type == "cpu":
        return row_walk_plain(feat, hlo, x0, win, bins=bins)
    if feat.device.type != "cuda":
        raise ValueError(f"row_walk runs on CPU or CUDA tensors, not {feat.device}")
    _, h, w, c = feat.shape
    if not feat.is_contiguous() or feat.data_ptr() % 16 or c * feat.element_size() % 16:
        raise ValueError("feat must be contiguous and 16-byte aligned, with C x its element "
                         "size a multiple of 16 bytes")
    hlo, x0 = hlo.contiguous(), x0.contiguous()
    out = torch.empty((1 + SCRATCH_SLOTS, bins, wd, c), dtype=torch.bfloat16, device=feat.device)
    _launch("row_walk.cu", f"wsovod_row_walk_{_SUFFIX[feat.dtype]}", None, [feat, hlo, x0, out],
            [h, w, c, ROWS, bins, wd, win is None, hlo.numel() // bins, SCRATCH_SLOTS],
            what="row_walk")
    LAUNCHES += 1
    return out[0]


def row_walk_plain(feat: torch.Tensor, hlo: torch.Tensor, x0: torch.Tensor, win: Optional[int],
                   *, bins: int = P) -> torch.Tensor:
    """``row_walk`` in plain PyTorch: every bin walked, in chunks of at most
    ``MAX_ELEMS`` gathered elements (at least one ROI's bins), widened to
    bfloat16 and folded; the last ROI's bins returned."""
    wd = _check(feat, hlo, x0, win, bins)
    fmap = feat[0]
    dev = feat.device
    neg = torch.tensor(-3e38, dtype=torch.bfloat16, device=dev)
    t = torch.arange(ROWS, device=dev)
    cols = torch.arange(wd, device=dev)
    step = bins * max(1, MAX_ELEMS // (bins * ROWS * wd * fmap.shape[-1]))  # whole ROIs
    for k0 in range(0, hlo.numel(), step):
        hs = (hlo[k0:k0 + step, None].long() + t)[:, :, None]  # [k, ROWS, 1]
        xs = cols if win is None else x0[k0:k0 + step, None].long() + cols
        walked = fmap[hs, xs.reshape(-1, 1, wd)].to(torch.bfloat16)  # [k, ROWS, wd, C]
        folded = torch.maximum(walked.amax(dim=1), neg)
    return folded[-bins:]


def make_inputs(device, h: int = H, w: int = W, c: int = CT, nb: int = NB, bins: int = P):
    """The JAX script's inputs from ``RandomState(0)``, in its order: the
    map ``[1, h, w, c]`` as ``{"bf16": ..., "int8": clip(x * 16, -127,
    127)}``, the rows ``hlo`` int32 ``[nb * RB * bins]`` in ``[0, h -
    ROWS)``, and per case the 8-aligned columns ``x0`` in ``[0, w - win]``
    (zeros, unread, for the full row)."""
    rng = np.random.RandomState(0)
    feat_f = rng.randn(1, h, w, c).astype(np.float32)
    feats = {"bf16": torch.from_numpy(feat_f).to(device).bfloat16(),
             "int8": torch.from_numpy(np.clip(feat_f * 16, -127, 127).astype(np.int8)).to(device)}
    n_meta = nb * RB * bins
    hlo = rng.randint(0, h - ROWS, n_meta).astype(np.int32)
    x0 = {}
    for name, _, win in CASES:
        wlim = w - (win or w)
        x0[name] = torch.from_numpy((rng.randint(0, wlim // 8 + 1, n_meta) * 8)
                                    .astype(np.int32)).to(device)
    return feats, torch.from_numpy(hlo).to(device), x0


def measure(feat: torch.Tensor, hlo: torch.Tensor, x0: torch.Tensor, win: Optional[int],
            reps: int = REPS) -> dict:
    """``row_walk`` on card tensors: its result held against the plain
    version bit for bit (raises otherwise); its ms over ``reps`` calls after
    a warm-up, the plain version's ms, the ms on the first quarter of the
    ROIs and their ratio; ns per row, the walk's GB/s (bytes of rows read)
    and the bound."""
    got = row_walk(feat, hlo, x0, win)
    want, plain_ms = timed(lambda: row_walk_plain(feat, hlo, x0, win))
    check_equal(got, want, f"row_walk {feat.dtype} win {win}")
    ms = cuda_ms(lambda: row_walk(feat, hlo, x0, win), reps)
    q = hlo.numel() // (P * RB) // 4 * (P * RB)  # whole grid steps
    quarter_ms = cuda_ms(lambda: row_walk(feat, hlo[:q], x0[:q], win), reps)
    _, _, w, c = feat.shape
    wd = w if win is None else win
    n_rows = hlo.numel() * ROWS
    compares = n_rows * wd * c
    in_bytes = feat.numel() * feat.element_size() + 2 * hlo.numel() * 4
    bound_ms, bound_by = bound(compares, in_bytes, P * wd * c * 2)
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": 0.0, "quarter_ms": quarter_ms,
            "quarter_ratio": quarter_ms / ms, "compares": compares,
            "ns_per_row": ms * 1e6 / n_rows,
            "walk_gb_per_s": compares * feat.element_size() / ms * 1e3 / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by}


def line(name: str, rec: dict) -> str:
    """The JAX script's line for one case, with the walk's rate, the bound,
    the plain version and the quarter count beside it."""
    return (f"{name}: {rec['ms']:.4f} ms  ({rec['ns_per_row']:.3f} ns/row); walk "
            f"{rec['walk_gb_per_s']:.1f} GB/s of rows read; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}: {rec['compares'] / 1e9:.3f} G compares); plain "
            f"{rec['plain_ms']:.3f} ms, equal; ROIs / 4: {rec['quarter_ms']:.4f} ms "
            f"(ratio {rec['quarter_ratio']:.3f})")


def main() -> int:
    dev = cuda_device("bench_i8walk")
    if dev is None:
        return 2
    print(f"card: {card_line()}; bin row walk of [1, {H}, {W}, {CT}]: {NB * RB} ROIs x {P} bins "
          f"x {ROWS} rows", flush=True)
    feats, hlo, x0 = make_inputs(dev)
    for name, dt, win in CASES:
        print(line(name, measure(feats[dt], hlo, x0[name], win)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
