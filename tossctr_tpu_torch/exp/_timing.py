"""What the card probes and ``chip_smoke.py`` share: the H100 SXM's peak
rates, against which a kernel's bound is taken, and a CUDA-event timer."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12  # CUDA-core fp32 rate: the bound of the hash's integer ops


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    """ms a call of ``fn`` over ``iters`` calls in a row on the current
    stream (CUDA events), after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
