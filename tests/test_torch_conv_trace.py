"""PyTorch port: the eval chunk's spans and counters (``train/gauge.py
make_eval_chunk``, ``dynamics/l2hmc.py``, ``networks/nets.py ConvNet``)
and the benchmark's readers of them and of the conv sampler's cell
(``bench_h100/metrics/``: ``host.eval_waits``, ``roofline.wilson``, and
``mfu.sample`` and ``idle_share`` in the conv sampler's cell).

The test marked ``cuda`` needs a card and skips without one.  This file
imports no JAX, so it also runs on the machine with the card::

    python -m pytest tests/test_torch_conv_trace.py --noconftest -q
"""

import pytest
import torch

from bench_h100.lib import common
from l2hmc_tpu_torch.lattice import u1
from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_params,
                                         make_eval_chunk)
from l2hmc_tpu_torch.utils import trace

K = 3
T = "eval.chunk/eval.transition"


@pytest.fixture(autouse=True)
def clean_recorder():
    trace.reset()
    yield
    trace.reset()


def conv_config(lt, chains):
    """The conv sampler's settings (the GaugeConfig defaults: conv f8,
    hidden 2 x_dim, the split integrator) at ``lt x lt``."""
    return GaugeConfig(time_size=lt, space_size=lt, num_chains=chains,
                       num_steps=K, eps_init=0.1, eps_trainable=False)


def test_torch_conv_eval_chunk_spans_per_transition():
    """Per transition: 2K momentum and 2K position conditioner calls, each
    with its conv stacks and trunk, K + 1 forces (the first before the
    leapfrog, then one cached per step), the observables; no wait."""
    cfg = conv_config(8, 4)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    x = u1.random_links(gen, 4, cfg.shape, device="cpu")
    n = 2
    with trace.recording():
        make_eval_chunk(cfg, n)(params, x, 4.0, gen)
    s = trace.summary()
    counts = {p: v["count"] for p, v in s["spans"].items()}
    calls = {"l2hmc.vnet": 2 * K, "l2hmc.xnet": 2 * K}
    want = {"eval.chunk": 1, T: n, f"{T}/eval.observables": n,
            f"{T}/l2hmc.force": n * (K + 1)}
    for net, c in calls.items():
        want[f"{T}/{net}"] = n * c
        for part in ("net.conv", "net.trunk"):
            want[f"{T}/{net}/{part}"] = n * c
    assert counts == want
    assert s["counters"].get("host.waits", 0) == 0
    per_transition = sum(counts.values()) / n
    assert per_transition <= 45       # coarse: about 40 per transition


# ---------------------------------------------------------------------------
# The readers, on made-up summaries and traces
# ---------------------------------------------------------------------------

MADE_UP = {"spans": {
    "bench.step": {"count": 2, "total_s": 1.0, "self_s": 0.0},
    "eval.chunk": {"count": 2, "total_s": 0.9, "self_s": 0.02},
    T: {"count": 40, "total_s": 0.88, "self_s": 0.1},
    f"{T}/l2hmc.force": {"count": 160, "total_s": 0.1, "self_s": 0.06},
    f"{T}/l2hmc.force/sync": {"count": 2, "total_s": 0.04, "self_s": 0.04},
    "other/sync": {"count": 1, "total_s": 5.0, "self_s": 5.0},
}, "counters": {"host.waits": 3}}


@pytest.mark.parametrize("name,want", [
    ("host.eval_waits", 3 / 40),
])
def test_torch_conv_eval_readers_on_a_made_up_summary(name, want):
    reader = common.load_module("metrics", name)
    assert reader.value(MADE_UP) == pytest.approx(want, rel=1e-12)
    assert reader.value({"spans": {"eval.chunk": MADE_UP["spans"][
        "eval.chunk"]}, "counters": {"host.waits": 1}}) is None
    assert reader.read(None) is None        # nothing recorded


def made_up_reading(kernels, transitions=8192 * 40, window_s=2.0,
                    busy_s=1.5, kernel="eval_chunk"):
    from bench_h100.lib.readings import Reading
    from bench_h100.lib.trace import Trace

    return Reading(
        trace=Trace(window_s=window_s, busy_s=busy_s, kernels=kernels),
        config=common.load_json("configs", "u1_16x16_conv"),
        config_name="u1_16x16_conv",
        work={"kernel": kernel, "chains": 8192, "transitions_per_call": 20,
              "num_leapfrog": 3, "transitions": transitions},
        window_s=window_s)


def test_torch_conv_roofline_wilson_by_kernel_kind():
    """The least time of each launch by its kind (the template's first
    argument, demangled or mangled): force 4 d + 1 floats per chain,
    action-only 2 d + 1; other kernels are not the Wilson's."""
    b, d = 8192, 256
    kernels = {
        "void wilson_kernel<2, 0>(WilsonArgs)": (4e-3, 40),
        "_Z13wilson_kernelILi1ELi1EEv10WilsonArgs": (1e-3, 20),
        "void wilson_slab_kernel<2>(SlabArgs)": (9.0, 1),
        "ampere_sgemm_128x64_nn": (7.0, 100),
    }
    least = 4 * b * (40 * (4 * d + 1) + 20 * (2 * d + 1)) / 3.35e12
    got = common.load_module("metrics", "roofline.wilson").read(
        made_up_reading(kernels))
    assert got == pytest.approx(100 * least / 5e-3, rel=1e-12)
    assert 0 < got < 100
    unreadable = {"wilson_kernel": (1e-3, 1)}
    for ks, kind in ((unreadable, "eval_chunk"), ({}, "eval_chunk"),
                     (kernels, "l2hmc_chain")):
        assert common.load_module("metrics", "roofline.wilson").read(
            made_up_reading(ks, kernel=kind)) is None


def test_torch_conv_mfu_and_idle_share_readers():
    """``mfu.sample`` in the conv sampler's cell: 12 conditioner calls of
    the published widths per chain transition over the window over 495
    TFLOP/s; ``idle_share``: the window's share without a device
    operation."""
    macs = (256 * 8 * 4 * 9 + 64 * 16 * 8 * 4      # position slot's stack
            + 256 * 8 * 2 * 9 + 64 * 16 * 8 * 4    # momentum slot's stack
            + 2 * 1024 * 1024 + 2 * 1024 + 1024 * 1024 + 1024 * 1536)
    r = made_up_reading({})
    got = common.load_module("metrics", "mfu.sample").read(r)
    assert got == pytest.approx(
        100 * 2 * 12 * macs * 8192 * 40 / 2.0 / 495e12, rel=1e-12)
    idle = common.load_module("metrics", "idle_share").read(r)
    assert idle == pytest.approx(25.0, rel=1e-12)
    wanted = {m["name"] for m in common.cell_metrics("sample.conv16", True)}
    assert {"mfu.sample", "idle_share", "roofline.wilson",
            "host.eval_waits"} <= wanted


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_torch_conv_eval_chunk_waits_for_nothing_on_the_card():
    """One chunk at the cell's size (16x16, 8192 chains) under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation of the path
    makes the host wait for the card, and no ``host.waits`` is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the eval chunk's host waits are "
                    "the card's")
    from l2hmc_tpu_torch._device import float32_matmuls

    float32_matmuls()
    dev = torch.device("cuda", 0)
    cfg = conv_config(16, 8192)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = init_params(cfg, gen, dev)
    x = u1.random_links(gen, 8192, cfg.shape, device=dev)
    chunk = make_eval_chunk(cfg, 2)
    chunk(params, x, 4.0, gen)               # the kernels built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with trace.recording():
            x_out, m = chunk(params, x, 4.0, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert trace.summary()["counters"].get("host.waits", 0) == 0
    assert bool(torch.isfinite(x_out).all())
    assert bool(((m["accept_prob"] >= 0) & (m["accept_prob"] <= 1)).all())
    assert m["plaqs"].shape == (2, 8192)
