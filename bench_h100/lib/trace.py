"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer readers take (device busy time, each kernel's device
time, the idle gaps and what the host was doing in them).

The window is the span ``bench.window`` recorded around the measured
loop; device activity (kernels, copies, fills) outside it is left out.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW_SPAN = "bench.window"
LABELLED_GAPS = 500        # the longest idle gaps that get a host label
BREAKDOWN_ROWS = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]       # name -> (seconds, count)
    idle_by_host: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def device_s(self) -> float:
        """Sum of every device operation's time (overlaps counted twice)."""
        return sum(s for s, _ in self.kernels.values())

    def seconds_of(self, match) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose name
        ``match(name)`` accepts."""
        s = n = 0
        for name, (sec, cnt) in self.kernels.items():
            if match(name):
                s += sec
                n += cnt
        return s, n

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])
        return {"device_ops": [[k[:120], v[0]] for k, v in
                               ops[:BREAKDOWN_ROWS]],
                "idle_gaps": [[k[:120], v] for k, v in
                              self.idle_by_host[:BREAKDOWN_ROWS]]}


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` (CPU and CUDA activity) around the block when
    ``enabled``; yields the profiler or ``None``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of ``(start, end)`` rows, sorted and disjoint."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def reduce(prof) -> Optional[Trace]:
    """The :class:`Trace` of a profiled window, or ``None`` where the
    profiler recorded no device activity in it."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == WINDOW_SPAN
              and e.device_type == DeviceType.CPU]
    if not window:
        return None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev, cpu = [], []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False) or (
                e.name.startswith("bench.")
                and e.device_type == DeviceType.CUDA):
            continue   # a host span's image on the device timeline
        if e.device_type == DeviceType.CUDA:
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            dev.append((s, t))
            k = kernels[e.name]
            k[0] += (t - s) * 1e-6
            k[1] += 1
        elif e.name != WINDOW_SPAN and t > w0 and s < w1:
            cpu.append((s, t, e.name))
    if not dev:
        return None
    busy = _merge(np.array(dev, dtype=np.float64))
    gaps = np.stack([np.concatenate([[w0], busy[:, 1]]),
                     np.concatenate([busy[:, 0], [w1]])], 1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    return Trace(window_s=(w1 - w0) * 1e-6,
                 busy_s=float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6,
                 kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                 idle_by_host=_label_gaps(gaps, cpu))


def _label_gaps(gaps: np.ndarray, cpu) -> List[Tuple[str, float]]:
    """Seconds of the longest idle gaps summed by the innermost host
    operation running at each gap's middle ("host idle" where none)."""
    if len(gaps) == 0:
        return []
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:LABELLED_GAPS]
    if cpu:
        cs = np.array([c[0] for c in cpu], dtype=np.float64)
        ce = np.array([c[1] for c in cpu], dtype=np.float64)
        names = [c[2] for c in cpu]
    by: Dict[str, float] = defaultdict(float)
    for s, e in longest:
        label = "host idle"
        if cpu:
            mid = 0.5 * (s + e)
            hit = np.nonzero((cs <= mid) & (ce >= mid))[0]
            if len(hit):
                label = names[hit[np.argmin(ce[hit] - cs[hit])]]
        by[label] += (e - s) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])


def span(name: str):
    """A host span in the trace (a no-op cost when not profiling)."""
    return torch.profiler.record_function(name)
