"""PyTorch port: the span and counter recorder (``utils/trace.py``), the
spans placed in the program, and what reads them: the benchmark's three
``host.chain_*`` readers, ``benchmarks/space_scaling.py``,
``benchmarks/config5_multihost.py``'s per-rank line and
``analysis/profile_digest.py``'s idle time by span.

The tests marked ``cuda`` need a card and skip without one.  This file
imports no JAX, so it also runs on the machine with the card::

    python -m pytest tests/test_torch_trace.py --noconftest -q
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from l2hmc_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
CHAIN_SPANS = {"chain.call", "chain.call/chain.weights",
               "chain.call/chain.seed", "chain.call/chain.launch"}


@pytest.fixture(autouse=True)
def clean_recorder():
    trace.reset()
    yield
    trace.reset()


def _user_annotations(prof):
    out = {}
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and (
                e.device_type == torch.autograd.DeviceType.CPU):
            out[e.name] = out.get(e.name, 0) + 1
    return out


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


def test_torch_trace_off_enters_no_range_and_keeps_nothing(monkeypatch):
    """Without a profiler and outside ``recording()``: the same null context
    for every span, no ``record_function`` entered, no record, no count."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("a") is trace.span("b") is trace.waiting()
    with trace.span("a"):
        with trace.waiting():
            trace.count("c", 3)
    assert trace.summary() == {"spans": {}, "counters": {}}
    assert trace.span_names() == set()


def test_torch_trace_spans_show_once_each_under_the_profiler():
    """Under ``torch.profiler`` every span is one CPU user annotation of the
    same name, as many as the recorder counts."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("t.outer"):
                with trace.span("t.inner"):
                    torch.ones(4).sum()
                with trace.waiting():
                    pass
    s = trace.summary()
    assert {p: v["count"] for p, v in s["spans"].items()} == {
        "t.outer": 3, "t.outer/t.inner": 3, "t.outer/sync": 3}
    seen = _user_annotations(prof)
    assert {k: seen.get(k) for k in ("t.outer", "t.inner", "sync")} == {
        "t.outer": 3, "t.inner": 3, "sync": 3}
    assert s["counters"] == {"host.waits": 3}
    assert trace.span_names() == {"t.outer", "t.inner", "sync"}
    assert trace.span("after") is trace.span("the profiler")


def test_torch_trace_self_time_is_total_less_the_children(monkeypatch):
    """On a made-up clock: outer [0, 100] holds a [10, 30] and b [40, 90],
    which holds c [50, 60]: self times 30, 20, 40, 10."""
    ticks = iter(t * 10 ** 9 for t in (0, 10, 30, 40, 50, 60, 90, 100))
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(ticks))
    with trace.recording():
        with trace.span("outer"):
            with trace.span("a"):
                pass
            with trace.span("b"):
                with trace.span("c"):
                    pass
    got = {p: (v["total_s"], v["self_s"])
           for p, v in trace.summary()["spans"].items()}
    want = {"outer": (100.0, 30.0), "outer/a": (20.0, 20.0),
            "outer/b": (50.0, 40.0), "outer/b/c": (10.0, 10.0)}
    assert got.keys() == want.keys()
    for p in want:
        assert got[p] == pytest.approx(want[p], rel=1e-12)


def test_torch_trace_counters_count_while_recording_and_reset_clears():
    trace.count("x")
    with trace.recording():
        trace.count("x", 3)
        trace.count("x")
        for _ in range(2):
            with trace.waiting():
                pass
        with trace.recording():
            trace.count("y")
        trace.count("y")
    trace.count("x")
    assert trace.summary()["counters"] == {"x": 4, "host.waits": 2, "y": 2}
    trace.reset()
    assert trace.summary() == {"spans": {}, "counters": {}}


def test_torch_trace_spans_nest_per_thread():
    """A span opened on another thread is not a child of this thread's."""
    import threading

    with trace.recording():
        with trace.span("main"):
            t = threading.Thread(target=lambda: trace.span("other")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    assert set(trace.summary()["spans"]) == {"main", "other"}


# ---------------------------------------------------------------------------
# Spans in the program, on the CPU
# ---------------------------------------------------------------------------


def test_torch_trace_spatial_ranges_reach_space_scaling():
    """``parallel/spatial.py``'s halo and 'space' sum, now recorder spans,
    still show under their names where ``space_scaling.py`` reads them (a
    one-rank sharding: its halos wrap locally, its sum is the identity,
    called here directly as a longer 'space' axis calls it)."""
    from l2hmc_tpu_torch.benchmarks import space_scaling
    from l2hmc_tpu_torch.lattice.u1 import LatticeShape
    from l2hmc_tpu_torch.parallel import spatial
    from l2hmc_tpu_torch.parallel.mesh import get_mesh, lattice_sharding

    sp = lattice_sharding(get_mesh(device="cpu"), LatticeShape(4, 4))
    t = torch.randn(2, 4, 4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = spatial._SpaceSum.apply(
            (sp.halo(t, 1, 1, 1) ** 2).sum(dim=(1, 2)), sp)
        y.sum().backward()
    shares = space_scaling._profile_shares(prof, 1.0)
    assert shares["halo_host_share"] > 0
    assert shares["space_sum_host_share"] > 0
    paths = trace.summary()["spans"]
    assert paths[spatial.HALO_RANGE]["count"] == 2   # and its transpose
    assert paths[spatial.SUM_RANGE]["count"] == 1


def test_torch_trace_cpu_reference_branches_record_no_chain_span():
    from l2hmc_tpu_torch.ops.leapfrog import hmc_chain

    links = torch.zeros(2, 4, 4, 2)
    with trace.recording():
        hmc_chain(links, torch.Generator().manual_seed(0), 0.1, 2.0, 2, 2)
    assert trace.summary() == {"spans": {}, "counters": {}}


def test_torch_trace_smc_rung_spans():
    """One process: a rung span per rung, each with its reweight, resample
    and move; the children's time is inside the rung's."""
    from l2hmc_tpu_torch.dynamics.smc import (make_u1_fused_move,
                                              smc_beta_ladder)
    from l2hmc_tpu_torch.lattice import u1
    from l2hmc_tpu_torch.ops.wilson import make_potential_fn

    shape = u1.LatticeShape(4, 4)
    gen = torch.Generator().manual_seed(0)
    x0 = u1.random_links(gen, 8, shape, device="cpu")
    with trace.recording():
        smc_beta_ladder(gen, x0, make_potential_fn(shape), [1.0, 1.5, 2.0],
                        make_u1_fused_move(shape, 2, 2))
    spans = trace.summary()["spans"]
    assert {p: v["count"] for p, v in spans.items()} == {
        "smc.rung": 2, "smc.rung/smc.reweight": 2,
        "smc.rung/smc.resample": 2, "smc.rung/smc.move": 2}
    rung = spans["smc.rung"]
    assert 0 <= rung["self_s"] < rung["total_s"]


def _config5_rank(argv):
    """On a spawned rank: ``config5_multihost.main(argv)``'s stderr JSON
    lines."""
    from l2hmc_tpu_torch.benchmarks import config5_multihost

    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(
            io.StringIO()):
        assert config5_multihost.main(argv) == 0
    return [json.loads(ln) for ln in err.getvalue().splitlines()
            if ln.startswith("{")]


def test_torch_trace_config5_fused_smc_prints_each_ranks_spans():
    """Two gloo ranks, ``--smc_move fused``: each rank prints its own line
    of the ladder's spans, its gathers under the rung's phases."""
    from l2hmc_tpu_torch.parallel.dryrun import spawn_local

    argv = ["--device", "cpu", "--size", "4", "--phases", "smc",
            "--smc_move", "fused", "--particles_per_device", "4",
            "--betas", "4", "--moves_per_rung", "2", "--leapfrog", "2"]
    lines = spawn_local(_config5_rank, 2, args=(argv,))
    for rank, out in enumerate(lines):
        assert len(out) == 1
        line = out[0]
        assert line["phase"] == "smc_rank_spans" and line["rank"] == rank
        spans = line["spans"]
        assert spans["smc.rung"]["count"] == 3
        for phase in ("reweight", "resample"):
            assert spans[f"smc.rung/smc.{phase}/mesh.all_gather"][
                "count"] == 3
        assert spans["smc.rung/smc.move"]["count"] == 3
        assert line["counters"] == {}        # no card: nothing waits


# ---------------------------------------------------------------------------
# The readers
# ---------------------------------------------------------------------------


def _reader(name):
    path = REPO / "bench_h100" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "test_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MADE_UP = {"spans": {
    "chain.call": {"count": 4, "total_s": 1.0, "self_s": 0.01},
    "chain.call/chain.weights": {"count": 4, "total_s": 0.9, "self_s": 0.1},
    "chain.call/chain.weights/sync": {"count": 8, "total_s": 0.8,
                                      "self_s": 0.8},
    "chain.call/chain.seed": {"count": 4, "total_s": 0.06, "self_s": 0.02},
    "chain.call/chain.seed/sync": {"count": 4, "total_s": 0.04,
                                   "self_s": 0.04},
    "chain.call/chain.launch": {"count": 4, "total_s": 0.03, "self_s": 0.03},
    "smc.move/sync": {"count": 5, "total_s": 7.0, "self_s": 7.0},
    "smc.move/chain.call": {"count": 1, "total_s": 0.5, "self_s": 0.5}},
    "counters": {"host.waits": 12}}


@pytest.mark.parametrize("name,want", [
    ("host.chain_wait_ms", 1e3 * 0.84 / 5),
    ("host.chain_prep_ms", 1e3 * (1.5 - 0.84) / 5),
    ("host.chain_waits", 12 / 5)])
def test_torch_trace_readers_on_a_made_up_summary(name, want):
    """Each ``bench_h100/metrics/host.chain_*`` reader: the waits inside
    every ``chain.call`` (and no other ``sync``) over the calls."""
    assert _reader(name).value(MADE_UP) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["host.chain_wait_ms", "host.chain_prep_ms",
                                  "host.chain_waits"])
def test_torch_trace_readers_read_nothing_without_a_chain_call(name):
    reader = _reader(name)
    assert reader.value({"spans": {}, "counters": {}}) is None
    assert reader.value({"spans": {"smc.rung": MADE_UP["spans"][
        "chain.call"]}, "counters": {"host.waits": 3}}) is None
    assert reader.read(None) is None        # nothing recorded


# ---------------------------------------------------------------------------
# The profile digest's idle time by span
# ---------------------------------------------------------------------------


def _event(name, start, end, device=False, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        is_user_annotation=annotation)


def test_torch_trace_profile_digest_idle_by_span():
    """Gaps between device operations, labelled by the span path at their
    middle: the device images of annotations are not work, spans the
    recorder does not name are no label."""
    from l2hmc_tpu_torch.analysis import profile_digest as pd

    events = [
        _event("k", 0, 100, device=True),
        _event("k", 150, 300, device=True),         # gap 100-150
        _event("copy", 280, 320, device=True),
        _event("k", 400, 500, device=True),         # gap 320-400
        _event("k", 600, 700, device=True),         # gap 500-600
        _event("chain.call", 90, 170, annotation=True),
        _event("sync", 95, 160, annotation=True),
        _event("chain.call", 310, 420, annotation=True),
        _event("bench.step", 0, 700, annotation=True),
        _event("chain.call", 0, 700, device=True, annotation=True),
        _event("aten::add", 320, 400),
    ]
    got = dict(pd._idle_by_span(events, {"chain.call", "sync"}))
    assert got == pytest.approx({"chain.call/sync": 50e-6,
                                 "chain.call": 80e-6, pd.NO_SPAN: 100e-6})
    assert pd._idle_by_span(events[5:8], {"chain.call"}) == []
    table = pd.format_idle(sorted(got.items(), key=lambda kv: -kv[1]))
    assert table.splitlines()[0].split() == ["idle", "under", "span",
                                             "idle_s", "pct"]
    assert "43.5%" in table      # no span: 100 of 230 us


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chain wrappers' spans are on "
                    "their card path")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _chain_call(kind, device, generator):
    from l2hmc_tpu_torch.lattice.u1 import typical_links
    from l2hmc_tpu_torch.ops import l2hmc_kernel as tl2
    from l2hmc_tpu_torch.ops import leapfrog as tlf
    from tests.test_torch_kernels import _local_params, _params

    lt = lx = 8
    links = torch.tensor(typical_links(np.random.default_rng(0), 4, lt, lx),
                         device=device)
    if kind == "hmc":
        return lambda: tlf.hmc_chain(links, generator, 0.1, 3.0, 3, 2)
    if kind == "mlp":
        params = _params(lt, lx, 3, 32, device)
        return lambda: tl2.l2hmc_chain(links, params, generator, 0.12, 3.0,
                                       3, 2)
    params = _local_params(lt, lx, 3, 4, 1, device)
    return lambda: tl2.l2hmc_local_chain(links, params, generator, 0.03, 3.0,
                                         3, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,gen_on_card,weights,waits", [
    ("hmc", False, False, 0), ("hmc", True, False, 1),
    ("mlp", False, True, 24), ("local", False, True, 1)])
def test_torch_trace_chain_wrappers_spans_on_the_card(
        cuda_device, kind, gen_on_card, weights, waits):
    """Each wrapper's span set per call on the card, and its waits for the
    card: the MLP's packing indexes with host indices (24 copies), the
    local net's masks check reads a flag back, ``draw_seed`` reads from a
    card's generator; ``hmc_chain`` with a host generator never waits."""
    gen = torch.Generator(device=cuda_device if gen_on_card else "cpu")
    call = _chain_call(kind, cuda_device, gen.manual_seed(1))
    call()
    torch.cuda.synchronize()
    with trace.recording():
        for _ in range(2):
            call()
    torch.cuda.synchronize()
    s = trace.summary()
    counts = {p: v["count"] for p, v in s["spans"].items()
              if not p.endswith("/sync")}
    want = CHAIN_SPANS - (set() if weights else {"chain.call/chain.weights"})
    assert counts == {p: 2 for p in want}
    assert s["counters"].get("host.waits", 0) == 2 * waits
    syncs = sum(v["count"] for p, v in s["spans"].items()
                if p.endswith("/sync"))
    assert syncs == 2 * waits
