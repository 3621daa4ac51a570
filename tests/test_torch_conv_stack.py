"""PyTorch port: the conv conditioner's conv stacks on ``csrc/conv_stack.cu``
(``ops/conv_stack.py``), the route ``ConvNet.forward`` takes to them
(``networks/nets.py conv_kernel_route``) and the benchmark's reader
``roofline.conv_stack``.

On the CPU: the plain version against ``ConvNet._stack`` (the eager stacks),
the route function, ``ConvNet.forward`` and an eval chunk with the route as
a card takes it (the wrapper's plain version in the kernel's place), the
reader on a made-up trace.  The tests marked ``cuda`` need a card and skip
without one.  This file imports no JAX, so it also runs on the machine with
the card::

    python -m pytest tests/test_torch_conv_stack.py --noconftest -q

Tolerance of the stacks (kernel or plain version against the eager
stacks, TF32 off): 1e-5 absolute and relative.  Each output is the ReLU of
a float32 sum of 32 products of ReLUs of sums of 18 or 36 products, inputs,
weights and outputs of order 1, summed in another order on each side
(cuDNN's or einsum's against the kernel's FMAs): they part by ~1e-6.  TF32
products (10-bit mantissas) would part them by ~1e-3.
"""

import dataclasses

import pytest
import torch

from bench_h100.lib import common
from l2hmc_tpu_torch.lattice import u1
from l2hmc_tpu_torch.networks import nets
from l2hmc_tpu_torch.ops import conv_stack as cs
from l2hmc_tpu_torch.train.gauge import (GaugeConfig, init_params,
                                         make_eval_chunk)
from l2hmc_tpu_torch.utils import trace

TOL = dict(atol=1e-5, rtol=1e-5)
K = 3


@pytest.fixture(autouse=True)
def clean_recorder():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/conv_stack.cu is CUDA C++ "
                    "for sm_90a and has no CPU mode")
    from l2hmc_tpu_torch._device import float32_matmuls

    float32_matmuls()
    return torch.device("cuda", 0)


def conv_net(lt, lx, pos, device="cpu", seed=0):
    """A conv net whose position slot ``pos`` ('x' or 'v') takes 4
    channels, its conv biases drawn too (the initialiser zeroes them)."""
    spec = nets.ConvNetSpec(lt, lx, num_hidden=16, **{f"{pos}_channels": 4})
    g = torch.Generator().manual_seed(seed)
    net = nets.make_conv_net(spec, g)
    with torch.no_grad():
        for c in (net.conv_x1, net.conv_x2, net.conv_v1, net.conv_v2):
            c.b.copy_(0.1 * torch.randn(c.b.shape, generator=g))
    return net.to(device)


def inputs(net, b, device="cpu", seed=1):
    spec = net.spec
    d = spec.time_size * spec.space_size
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(b, spec.v_channels * d, generator=g)
    x = torch.randn(b, spec.x_channels * d, generator=g)
    return v.to(device), x.to(device)


def slots(net, v, x):
    return [(x, net.conv_x1.w, net.conv_x1.b, net.conv_x2.w, net.conv_x2.b),
            (v, net.conv_v1.w, net.conv_v1.b, net.conv_v2.w, net.conv_v2.b)]


def eager(net, v, x):
    return (net._stack(net.conv_x1, net.conv_x2, x),
            net._stack(net.conv_v1, net.conv_v2, v))


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lt,lx,pos", [(8, 8, "x"), (16, 16, "v"),
                                       (6, 10, "x"), (2, 4, "v")])
def test_torch_conv_stack_reference_matches_eager_stacks(lt, lx, pos):
    """The plain version (rolled taps, 2x2 blocks) is the eager stacks
    (``to_image``, circular pads, ``F.conv2d``) on both slots."""
    net = conv_net(lt, lx, pos)
    v, x = inputs(net, 5)
    before = cs.conv_stack.launches
    with torch.no_grad():
        got = cs.conv_stack(slots(net, v, x), lt, lx)
        want = eager(net, v, x)
    assert cs.conv_stack.launches == before     # no launch on the CPU
    for g, w in zip(got, want):
        assert g.shape == (5, 16 * (lt // 2) * (lx // 2))
        torch.testing.assert_close(g, w, **TOL)


BASE = nets.ConvNetSpec(16, 16, x_channels=4)


@pytest.mark.parametrize("spec,cuda,f32,grad,want", [
    (BASE, True, True, False, True),
    (dataclasses.replace(BASE, x_channels=2, v_channels=4), True, True,
     False, True),
    (dataclasses.replace(BASE, time_size=8, space_size=8), True, True, False,
     True),
    (dataclasses.replace(BASE, time_size=32, space_size=32), True, True,
     False, True),
    (BASE, True, True, True, False),                   # grad to record
    (BASE, False, True, False, False),                 # CPU tensors
    (BASE, True, False, False, False),                 # float64 inputs
    (dataclasses.replace(BASE, use_lrn=True), True, True, False, False),
    (dataclasses.replace(BASE, use_bf16=True), True, True, False, False),
    (dataclasses.replace(BASE, time_size=15), True, True, False, False),
    (dataclasses.replace(BASE, time_size=64, space_size=64), True, True,
     False, False),                                    # 1024 positions
    (dataclasses.replace(BASE, num_filters=4), True, True, False, False),
    (dataclasses.replace(BASE, filter_size1=5), True, True, False, False),
])
def test_torch_conv_kernel_route(spec, cuda, f32, grad, want):
    assert nets.conv_kernel_route(spec, cuda, f32, grad) is want


def as_on_a_card(monkeypatch):
    """The route as a card takes it, on CPU tensors: the wrapper then runs
    its plain version where the kernel would run."""
    route = nets.conv_kernel_route
    monkeypatch.setattr(nets, "conv_kernel_route",
                        lambda spec, cuda, f32, grad: route(spec, True, f32,
                                                            grad))


@pytest.mark.parametrize("pos", ["x", "v"])
def test_torch_conv_forward_takes_the_route_without_grad(monkeypatch, pos):
    """Without grad, ``forward`` takes the kernel's route (one count of
    ``net.conv_kernel`` a call, the slots in their places); with grad on
    and parameters that require it, the eager stacks, bit for bit."""
    net = conv_net(8, 8, pos)
    v, x = inputs(net, 3)
    t = torch.randn(3, 2)
    with torch.no_grad():
        want = net(v, x, t)
    want_grad = net(v, x, t)
    as_on_a_card(monkeypatch)
    with trace.recording():
        with torch.no_grad():
            got = net(v, x, t)
        assert trace.summary()["counters"][nets.CONV_KERNEL_COUNTER] == 1
        got_grad = net(v, x, t)
        assert trace.summary()["counters"][nets.CONV_KERNEL_COUNTER] == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    for g, w in zip(got_grad, want_grad):
        assert torch.equal(g, w)


def test_torch_conv_forward_keeps_float64_on_the_eager_stacks(monkeypatch):
    """float64 inputs (the ``L2HMC_FLOAT=float64`` debugging mode) take the
    eager stacks on the route a card takes: the kernel is float32 only."""
    net = conv_net(8, 8, "x").double()
    v, x = (a.double() for a in inputs(net, 3))
    t = torch.randn(3, 2, dtype=torch.float64)
    with torch.no_grad():
        want = net(v, x, t)
        as_on_a_card(monkeypatch)
        with trace.recording():
            got = net(v, x, t)
            assert nets.CONV_KERNEL_COUNTER not in trace.summary()["counters"]
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and torch.equal(g, w)


def conv_config(lt, chains):
    """The conv sampler's settings (the GaugeConfig defaults: conv f8,
    hidden 2 x_dim, the split integrator) at ``lt x lt``."""
    return GaugeConfig(time_size=lt, space_size=lt, num_chains=chains,
                       num_steps=K, eps_init=0.1, eps_trainable=False)


def test_torch_conv_eval_chunk_counts_a_kernel_call_per_conditioner_call(
        monkeypatch):
    """An eval chunk on the route a card takes: ``net.conv_kernel`` once
    per conditioner call, 4 K a transition; the chunk's answers as on the
    eager stacks: accept probabilities within 2e-5 and links within 2e-5
    mod 2 pi after 2 transitions (the conditioner's outputs part by ~1e-6
    and the energy change sums ~1e3 terms)."""
    cfg = conv_config(8, 4)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    x = u1.random_links(gen, 4, cfg.shape, device="cpu")
    n = 2
    chunk = make_eval_chunk(cfg, n)
    want = chunk(params, x, 4.0, torch.Generator().manual_seed(5))
    as_on_a_card(monkeypatch)
    with trace.recording():
        got = chunk(params, x, 4.0, torch.Generator().manual_seed(5))
    assert trace.summary()["counters"][nets.CONV_KERNEL_COUNTER] == \
        n * 4 * K
    assert float((got[1]["accept_prob"] - want[1]["accept_prob"])
                 .abs().max()) < 2e-5
    d = torch.remainder(got[0] - want[0] + torch.pi, 2 * torch.pi) - torch.pi
    assert float(d.abs().max()) < 2e-5


@pytest.mark.parametrize("kw", [
    {}, {"merge_v_halves": True}, {"both_directions": True},
    {"network_arch": "mlp"}, {"hmc": True},
    {"time_size": 64, "space_size": 64},              # 1024 positions
])
def test_torch_conv_stack_launches_as_derived(monkeypatch, kw):
    """The conditioner calls of one eval transition that take the kernel's
    route are those chip_smoke.py derives for ``conv_stack``'s launches
    on its main paths (``conv_stack_launches_per_transition``)."""
    import chip_smoke

    cfg = GaugeConfig(**{"time_size": 4, "space_size": 4, "num_chains": 2,
                         "num_steps": 2, "num_hidden": 8, "eps_init": 0.1,
                         "eps_trainable": False, **kw})
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    x = u1.random_links(gen, 2, cfg.shape, device="cpu")
    as_on_a_card(monkeypatch)
    with trace.recording():
        make_eval_chunk(cfg, 1)(params, x, 4.0, gen)
        got = trace.summary()["counters"].get(nets.CONV_KERNEL_COUNTER, 0)
    assert got == chip_smoke.conv_stack_launches_per_transition(cfg)


def made_up_reading(kernels, kernel="eval_chunk"):
    from bench_h100.lib.readings import Reading
    from bench_h100.lib.trace import Trace

    return Reading(
        trace=Trace(window_s=2.0, busy_s=1.5, kernels=kernels),
        config=common.load_json("configs", "u1_16x16_conv"),
        config_name="u1_16x16_conv",
        work={"kernel": kernel, "chains": 8192, "transitions_per_call": 20,
              "num_leapfrog": 3, "transitions": 8192 * 40},
        window_s=2.0)


def test_torch_roofline_conv_stack_reader():
    """Each launch's least time, both slots over 8192 chains of 16x16:
    2.886 GFLOP at 67 TFLOP/s (43.1 us) against 117.4 MB at 3.35 TB/s;
    demangled and mangled names count, other kernels do not; ``None``
    where no launch was traced (a program without the kernel) or outside
    the eval chunk's cell."""
    kernels = {
        "(anonymous namespace)::conv_stack_kernel((anonymous namespace)"
        "::Args)": (3e-3, 24),
        "_ZN12_GLOBAL__N_117conv_stack_kernelENS_4ArgsE": (1e-3, 8),
        "void implicit_convolve_sgemm<float, float, 1024, 5, 5>": (9.0, 10),
        "void wilson_kernel<2, 0>(WilsonArgs)": (4e-3, 40),
    }
    macs = 256 * 8 * 4 * 9 + 256 * 8 * 2 * 9 + 2 * 64 * 16 * 8 * 4
    assert macs == 176128
    least = max(2 * 8192 * macs / 67e12, 8192 * 4 * 256 * 14 / 3.35e12)
    assert least == pytest.approx(43.07e-6, rel=1e-3)
    reader = common.load_module("metrics", "roofline.conv_stack")
    got = reader.read(made_up_reading(kernels))
    assert got == pytest.approx(100 * 32 * least / 4e-3, rel=1e-12)
    assert 0 < got < 100
    assert reader.read(made_up_reading(
        {k: v for k, v in kernels.items() if "conv_stack" not in k})) is None
    assert reader.read(made_up_reading(kernels, "l2hmc_chain")) is None
    wanted = {m["name"] for m in common.cell_metrics("sample.conv16", True)}
    assert "roofline.conv_stack" in wanted
    assert all("roofline.conv_stack" not in
               {m["name"] for m in common.cell_metrics(c, True)}
               for c in ("sample.champion16", "sample.hmc16",
                         "sample.local64"))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("lt,lx,b,pos,aligned", [
    (16, 16, 8192, "x", True),      # the cell's shapes, 2 chains a CTA
    (16, 16, 8192, "v", True),
    (16, 16, 1001, "x", False),     # a ragged last CTA; an input off 16 B
    (8, 8, 1003, "v", True),        # 8 chains a CTA, the last holds 3
    (32, 32, 257, "x", True),       # one chain of 256 positions a CTA
    (6, 10, 37, "v", True),         # 8 chains of 15 positions a CTA
])
def test_torch_conv_stack_kernel_matches_eager_stacks(cuda_device, lt, lx, b,
                                                      pos, aligned):
    """The kernel against the eager stacks (cuDNN, TF32 off) and the plain
    version, both slots; one launch."""
    net = conv_net(lt, lx, pos, cuda_device)
    v, x = inputs(net, b, cuda_device)
    if not aligned:
        buf = torch.empty(x.numel() + 1, device=cuda_device)
        buf[1:].copy_(x.reshape(-1))
        x = buf[1:].view(x.shape)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    before = cs.conv_stack.launches
    with torch.no_grad():
        got = cs.conv_stack(slots(net, v, x), lt, lx)
        want = eager(net, v, x)
        plain = [cs.conv_stack_reference(*s, lt, lx)
                 for s in slots(net, v, x)]
    torch.cuda.synchronize()
    assert cs.conv_stack.launches - before == 1
    for g, w, p in zip(got, want, plain):
        torch.testing.assert_close(g, w, **TOL)
        torch.testing.assert_close(g, p, **TOL)


@pytest.mark.cuda
def test_torch_conv_stack_refuses_what_the_kernel_does_not_take(cuda_device):
    big = conv_net(64, 64, "x", cuda_device)      # 1024 positions
    with pytest.raises(ValueError):
        cs.conv_stack(slots(big, *inputs(big, 2, cuda_device)), 64, 64)
    net = conv_net(16, 16, "x", cuda_device)
    v, x = inputs(net, 4, cuda_device)
    with pytest.raises(ValueError):
        cs.conv_stack(slots(net, v, x.t().contiguous().t()), 16, 16)
    with pytest.raises(ValueError):
        cs.conv_stack(slots(net, v.cpu(), x), 16, 16)


@pytest.mark.cuda
def test_torch_conv_eval_chunk_takes_the_kernel_on_the_card(cuda_device):
    """One chunk of 2 transitions at the cell's size (16x16, 8192 chains)
    under ``torch.cuda.set_sync_debug_mode("error")``: every conditioner
    call takes the kernel (``net.conv_kernel`` and ``conv_stack.launches``
    4 K a transition), and nothing waits for the card."""
    dev = cuda_device
    cfg = conv_config(16, 8192)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = init_params(cfg, gen, dev)
    x = u1.random_links(gen, 8192, cfg.shape, device=dev)
    chunk = make_eval_chunk(cfg, 2)
    chunk(params, x, 4.0, gen)               # the kernels built and loaded
    torch.cuda.synchronize()
    before = cs.conv_stack.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with trace.recording():
            x_out, m = chunk(params, x, 4.0, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counters = trace.summary()["counters"]
    assert counters[nets.CONV_KERNEL_COUNTER] == 2 * 4 * K
    assert cs.conv_stack.launches - before == 2 * 4 * K
    assert counters.get("host.waits", 0) == 0
    assert bool(torch.isfinite(x_out).all())
