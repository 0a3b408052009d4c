"""Entry points of the port that measure kernels on the card rather than run
the model: the CUDA counterparts of the JAX package's TPU microbenchmarks
(kernel 2.9), each a walk of one map resident in the L2 that bounds the pool
kernels' load path:

    python -m wsovod_torch.scripts.bench_vpu_pack   # row fold: f32, bf16, int8
    python -m wsovod_torch.scripts.bench_i8walk     # bin row walk: cases A-F

Each needs a CUDA device and exits non-zero without one. Each holds every
kernel result against its plain PyTorch version bit for bit and catches
nothing: a failed case ends the run with a non-zero exit. This module holds
the measuring that the two share with ``chip_smoke.py``: the card line,
CUDA-event timing and the bound.
"""

from __future__ import annotations

import subprocess
import sys

# NVIDIA H100 SXM data sheet: HBM rate, and the float32 rate outside the
# tensor cores (the pool kernels and the walks compare in float32 or less)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def bound(ops: int, in_bytes: int, out_bytes: int):
    """Least time (ms) on the card for a kernel call, and what sets it: the
    bytes it must move (each input read once, each output written once) over
    HBM's rate, against its operations (one compare per element walked or
    per bin pixel and channel, the align's multiply-adds, one gate multiply
    per output) over the float32 rate; the larger wins."""
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


SPIN_CYCLES = 10_000_000  # about 5 ms at the H100's clocks


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``reps`` calls of ``fn`` after one warm-up call, by CUDA
    events around the calls. A spin kernel queued first holds the card while
    the host queues the calls, so the time is the card's even where a call
    takes less time on the card than its launch takes on the host (the int8
    row fold at a quarter of its pseudo-ROIs: about 30 us)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
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


def cuda_device(prog: str):
    """The first CUDA device, or ``None`` after saying on stderr that
    ``prog`` measures on a GPU only."""
    import torch

    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device; this script measures the port's kernels on a GPU only",
              file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def check_equal(got, want, what: str) -> None:
    """Raise unless ``got`` equals ``want`` bit for bit (dtype, shape,
    values)."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        err = ((got.float() - want.float()).abs().max().item()
               if got.shape == want.shape else float("inf"))
        raise AssertionError(f"{what}: kernel != plain ({got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}; max |err| {err})")
