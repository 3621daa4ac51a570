"""Cost decomposition of the chain kernels on the card.

Ports of the JAX package's ``benchmarks/vpu_roofline.py``,
``benchmarks/kernel_decomposition.py`` and ``benchmarks/local_kernel_bench.py``,
each run as a module from the repository root on a CUDA card::

    python3 -m l2hmc_tpu_torch.benchmarks.vpu_roofline --measure_kernel
    python3 -m l2hmc_tpu_torch.benchmarks.kernel_decomposition
    python3 -m l2hmc_tpu_torch.benchmarks.local_kernel_bench

Each prints one JSON line with the card's name and power limit beside its
times.  Times come from CUDA events; a script without a card raises.
"""

from __future__ import annotations

import subprocess

import torch


def best_ms(fn, reps: int, inner: int = 1) -> float:
    """Least milliseconds per call of ``fn()`` on the card over ``reps``
    timings after one warm-up call, each timing ``inner`` back-to-back calls
    between two CUDA events.  With ``inner > 1`` the host enqueues a call
    while the card runs the one before, so a call whose device time exceeds
    the host's enqueue time is timed without it."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def device_info() -> dict:
    """The card's name (torch) and ``nvidia-smi``'s name and power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi_name_power_limit": smi}


def device_profile(fn, reps: int, tries: int = 2):
    """``(device ms per call, kernels per call, [(kernel, device ms per
    call)] top five)`` of ``fn`` over ``reps`` calls from torch.profiler's
    CUDA activity; ``None`` when the profiler recorded no device time in
    ``tries`` windows (it occasionally drops a window's kernels)."""
    for _ in range(tries):
        prof = _device_profile_once(fn, reps)
        if prof is not None:
            return prof
    return None


def _device_profile_once(fn, reps):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        rows.append((e.key, us / 1e3 / reps, e.count / reps))
    total = sum(r[1] for r in rows)
    if total <= 0:
        return None
    rows.sort(key=lambda r: -r[1])
    return (total, sum(r[2] for r in rows),
            [(k[:60], ms) for k, ms, _ in rows[:5]])
