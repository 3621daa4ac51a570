"""Spans and counters of the program's host path.

A span is a named interval of the host thread (``with span("chain.call"):``);
spans opened inside it are its children.  A counter is a named count kept
at the same places (``count("host.waits")``).  :func:`waiting` marks a point
where the host thread waits for the card: one ``sync`` span and one count
of ``host.waits``.

The recorder records only while a ``torch.profiler`` is recording (one C
call, ``torch._C._autograd._profiler_enabled()``, tells) or inside
:func:`recording`, for a script that reports spans without a profiler.
Otherwise :func:`span` returns a shared null context after that one check
and :func:`count` returns after it: no ``record_function`` is entered, no
record kept.  While recording, a span also enters
``torch.profiler.record_function(name)`` when a profiler is on, so it sits
on the profiler's timeline on the kernels' clock, and it keeps a record in
memory (name, parent span, start and end by ``time.perf_counter_ns``).

:func:`summary` gives per span path (``"chain.call/chain.weights/sync"``)
the count, total seconds and self seconds (the total less what its
children cover), and the counters; :func:`reset` clears them.  Readers:
``bench_h100/metrics/host.chain_*.py`` (the chain wrappers' spans),
``bench_h100/metrics/host.eval_*.py`` (the eval chunk's ``eval.*`` spans
and ``host.waits``),
``benchmarks/config5_multihost.py`` (the SMC rung's, per rank),
``benchmarks/space_scaling.py`` (the ``lattice_sharding.*`` spans),
``analysis/profile_digest.py`` (the device's idle time by span) and the
card tests of the MLP chain (``chain.cluster_route``, one count per launch
on its cluster route).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

WAIT_SPAN = "sync"
WAIT_COUNTER = "host.waits"

_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "parent", "start", "end")

    def __init__(self, name: str, parent: Optional["_Record"], start: int):
        self.name, self.parent = name, parent
        self.start, self.end = start, None

    def path(self) -> str:
        names, r = [], self
        while r is not None:
            names.append(r.name)
            r = r.parent
        return "/".join(reversed(names))


class _Span:
    __slots__ = ("recorder", "name", "rf", "rec")

    def __init__(self, recorder: "Recorder", name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = self.recorder._open(self.name)
        return self

    def __exit__(self, *exc):
        self.recorder._close(self.rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Recorder:
    """The spans and counters of one process; each thread nests its own
    spans."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self.forced = 0
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.records: List[_Record] = []
            self.counters: Dict[str, int] = defaultdict(int)
            self.names = set()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open(self, name: str) -> _Record:
        st = self._stack()
        rec = _Record(name, st[-1] if st else None, time.perf_counter_ns())
        st.append(rec)
        with self._lock:
            self.records.append(rec)
            self.names.add(name)
        return rec

    def _close(self, rec: _Record) -> None:
        rec.end = time.perf_counter_ns()
        st = self._stack()
        if st and st[-1] is rec:
            st.pop()

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] += n

    def summary(self) -> dict:
        with self._lock:
            closed = [r for r in self.records if r.end is not None]
            counters = dict(self.counters)
        child_ns: Dict[int, int] = defaultdict(int)
        for r in closed:
            if r.parent is not None:
                child_ns[id(r.parent)] += r.end - r.start
        spans: Dict[str, dict] = {}
        for r in closed:
            s = spans.setdefault(r.path(), {"count": 0, "total_s": 0.0,
                                            "self_s": 0.0})
            dur = r.end - r.start
            s["count"] += 1
            s["total_s"] += dur * 1e-9
            s["self_s"] += (dur - child_ns[id(r)]) * 1e-9
        return {"spans": spans, "counters": counters}


RECORDER = Recorder()


def span(name: str):
    """A span named ``name`` around the ``with`` block (a shared null
    context when not recording)."""
    return _Span(RECORDER, name) if RECORDER.forced or _profiling() else _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing when not recording)."""
    if RECORDER.forced or _profiling():
        RECORDER.add(name, n)


def waiting():
    """Around a point where the host thread waits for the card: the span
    :data:`WAIT_SPAN` and one count of :data:`WAIT_COUNTER`."""
    if not (RECORDER.forced or _profiling()):
        return _NULL
    RECORDER.add(WAIT_COUNTER, 1)
    return _Span(RECORDER, WAIT_SPAN)


@contextlib.contextmanager
def recording():
    """Record spans and counts in the block, with or without a profiler."""
    RECORDER.forced += 1
    try:
        yield RECORDER
    finally:
        RECORDER.forced -= 1


def summary() -> dict:
    """``{"spans": {path: {"count", "total_s", "self_s"}}, "counters":
    {name: n}}`` of what was recorded since the last :func:`reset`."""
    return RECORDER.summary()


def reset() -> None:
    RECORDER.reset()


def span_names() -> set:
    """The names of the spans recorded since the last :func:`reset`."""
    with RECORDER._lock:
        return set(RECORDER.names)
