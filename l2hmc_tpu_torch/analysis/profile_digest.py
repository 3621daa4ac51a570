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

Beside the table, :func:`idle_by_span` sums the card's idle time (the
gaps between the first and the last device operation) by the program's
span (``utils/trace.py``) innermost at each gap's middle, named by its
path (``chain.call/chain.weights/sync``), ``no span`` where none ran.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

NO_SPAN = "no span"


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


def idle_by_span(prof) -> List[Tuple[str, float]]:
    """``(span path, idle seconds)`` rows of a finished profile, largest
    first: the card's idle gaps between its first and last operation,
    summed by the span of ``utils/trace.py`` innermost at each gap's
    middle.  Empty where the profile holds no device operation."""
    from l2hmc_tpu_torch.utils import trace

    return _idle_by_span(prof.events(), trace.span_names())


def _idle_by_span(events, names) -> List[Tuple[str, float]]:
    busy, spans = [], []
    for e in events:
        r = (e.time_range.start, e.time_range.end)
        if e.name in names or getattr(e, "is_user_annotation", False):
            if e.name in names and not _is_device(e):
                spans.append((*r, e.name))
        elif _is_device(e) and r[1] > r[0]:
            busy.append(r)
    if not busy:
        return []
    busy.sort()
    gaps, end = [], busy[0][1]
    for s, t in busy[1:]:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    by: Dict[str, float] = defaultdict(float)
    if spans:
        ss = np.array([s[0] for s in spans], dtype=np.float64)
        se = np.array([s[1] for s in spans], dtype=np.float64)
    for s, t in gaps:
        label = NO_SPAN
        if spans:
            mid = 0.5 * (s + t)
            hit = np.nonzero((ss <= mid) & (se >= mid))[0]
            if len(hit):
                label = "/".join(spans[i][2] for i in
                                 sorted(hit, key=lambda i: (ss[i], -se[i])))
        by[label] += (t - s) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])


def format_idle(rows: List[Tuple[str, float]]) -> str:
    """The idle rows as a table with each row's share of the idle time."""
    total = sum(s for _, s in rows) or 1.0
    width = min(max([len(r[0]) for r in rows] + [15]), 80)
    lines = [f"{'idle under span':<{width}}  {'idle_s':>10}  {'pct':>6}",
             "-" * (width + 22)]
    lines += [f"{name[:width]:<{width}}  {sec:>10.6f}  "
              f"{100 * sec / total:>5.1f}%" for name, sec in rows]
    return "\n".join(lines) + "\n"


def write_digest(prof, run_dir, top_k: int = 25) -> Optional[Path]:
    """Digest a finished profile and write ``<run_dir>/profile_top_ops.txt``:
    the op table, then the device's idle time by program span where the
    profile has device operations; returns the path, or ``None`` when the
    profile holds no timed event."""
    rows = digest_profile(prof, top_k)
    if not rows:
        return None
    idle = idle_by_span(prof)
    out = Path(run_dir) / "profile_top_ops.txt"
    out.write_text(format_table(rows)
                   + ("\n" + format_idle(idle) if idle else ""))
    return out
