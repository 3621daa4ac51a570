"""Op-level digest of a ``torch.profiler`` trace (port of
``l2hmc_tpu/analysis/profile_digest.py``).

The reference dumps an op-view auto-profiling report right after its
traced training window (``gauge_model.py:1048-1071``).  The port traces
the same window with ``torch.profiler`` (``cli/train_gauge.py
--profile``), writes the chrome trace to ``<trace_dir>/trace.json.gz`` and
digests the profile into the reference's table, the top ops by total
device time, in ``<run_dir>/profile_top_ops.txt``.

Device time is the card's kernel time (the CUDA events of the trace: the
device lane, as the JAX digest takes the TPU's); where the profile holds
no device event (a run on the CPU) the table ranks the CPU operators by
their self time.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import List, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(trace_dir, device=None, export: bool = True):
    """Profile the body with ``torch.profiler`` (CPU, and CUDA when
    ``device`` is a card; the card is synchronized before the trace ends)
    and, with ``export``, write its chrome trace to
    ``<trace_dir>/trace.json.gz``.  Yields
    the profiler, whose events :func:`write_digest` reads once the body is
    done."""
    from torch.profiler import ProfilerActivity, profile

    on_card = device is not None and torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize(device)
    if not export:
        return
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json.gz"))


def _is_device(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def digest_profile(prof, top_k: int = 25
                   ) -> List[Tuple[str, float, int, float]]:
    """``(op_name, total_ms, count, pct)`` rows of a finished profile,
    sorted by total time, truncated to ``top_k``: the device events by
    their device time where the profile has any, else the CPU operators
    by their self time."""
    events = list(prof.key_averages())
    device = [e for e in events if _is_device(e)]
    if device:
        timed = [(e.key, float(e.self_device_time_total), e.count)
                 for e in device]
    else:
        timed = [(e.key, float(e.self_cpu_time_total), e.count)
                 for e in events if not e.key.startswith("ProfilerStep")]
    timed = [t for t in timed if t[1] > 0]
    grand = sum(t for _, t, _ in timed) or 1.0
    rows = sorted(timed, key=lambda r: -r[1])[:top_k]
    return [(name, t / 1e3, n, 100.0 * t / grand) for name, t, n in rows]


def format_table(rows: List[Tuple[str, float, int, float]]) -> str:
    """Reference-style op-view table (total-ms ordered)."""
    if not rows:
        return "no trace events found\n"
    width = max(len(r[0]) for r in rows)
    width = min(max(width, 8), 80)
    lines = [
        f"{'op':<{width}}  {'total_ms':>10}  {'count':>7}  {'pct':>6}",
        "-" * (width + 30),
    ]
    for name, ms, n, pct in rows:
        lines.append(f"{name[:width]:<{width}}  {ms:>10.3f}  {n:>7d}  "
                     f"{pct:>5.1f}%")
    return "\n".join(lines) + "\n"


def write_digest(prof, run_dir, top_k: int = 25) -> Optional[Path]:
    """Digest a finished profile and write ``<run_dir>/profile_top_ops.txt``;
    returns the path, or ``None`` when the profile holds no timed event."""
    rows = digest_profile(prof, top_k)
    if not rows:
        return None
    out = Path(run_dir) / "profile_top_ops.txt"
    out.write_text(format_table(rows))
    return out
