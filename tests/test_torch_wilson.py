"""PyTorch port, ops/wilson.py: the Wilson action's kernels' plain versions,
the kernel path's autograd wiring, the routes of ``wilson_plan`` and the
dynamics' use of the potential's ``force``, against JAX.

The JAX side is the reference's Pallas kernel run in interpret mode
(``wilson_action_pallas(..., interpret=True)``, as tests/test_ops.py runs
it) for the value and the gradient, and the analytic-VJP ``wilson_action``
differentiated twice for the force's backward (JAX forms that derivative in
XLA, outside any Pallas kernel).  On CPU tensors the kernel wrappers run
their plain versions, so :class:`WilsonActionKernel` and
:class:`WilsonForceFn` are exercised here with the same formulas the CUDA
kernels implement; the kernels themselves are held against these plain
versions on the card (tests/test_torch_kernels.py).

Tolerances: S to rtol 1e-5 (float32 sums of up to 64 terms in another
order), first and second derivatives to atol 1e-5 / 1e-4 (O(1) entries,
different libm sin/cos and summation order).  The potential's ``force``
against autograd of the plain potential, both in torch on the CPU: the same
ops in the same order, so rtol and atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.ops import wilson as jw
from l2hmc_tpu_torch.ops import wilson as tw

torch.set_num_threads(1)


def _links(seed, b=4, lt=4, lx=6):
    return np.random.default_rng(seed).uniform(
        -np.pi, np.pi, (b, lt, lx, 2)).astype(np.float32)


@pytest.mark.parametrize("lt,lx", [(2, 2), (4, 6), (8, 8)])
def test_torch_wilson_plain_matches_jax_pallas_interpret(lt, lx):
    links = _links(lt * 10 + lx, 4, lt, lx)
    jl = jnp.asarray(links)
    want = np.asarray(jw.wilson_action_pallas(jl, interpret=True))
    want_g = np.asarray(jax.grad(lambda l: jnp.sum(
        3.0 * jw.wilson_action_pallas(l, interpret=True)))(jl))
    x = torch.from_numpy(links).requires_grad_(True)
    s = tw.wilson_action(x)
    (g,) = torch.autograd.grad(3.0 * s.sum(), x)
    np.testing.assert_allclose(s.detach().numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), want_g, atol=1e-5)
    # the forward and backward kernels' plain versions give the same
    s_r, sinp = tw.wilson_forward_reference(torch.from_numpy(links))
    np.testing.assert_allclose(s_r.numpy(), want, rtol=1e-5)
    force = tw.wilson_backward_reference(sinp, torch.full((4,), 3.0))
    np.testing.assert_allclose(force.numpy(), want_g, atol=1e-5)


def _jax_force_vjp(links, g, w):
    """(d links, d g) of ``w . g dS/dlinks`` by JAX (grad of the analytic
    VJP), the reference's second derivative."""
    def force(l, gg):
        return jax.grad(lambda y: jnp.sum(gg * jw.wilson_action(y)))(l)

    _, vjp = jax.vjp(force, jnp.asarray(links), jnp.asarray(g))
    dl, dg = vjp(jnp.asarray(w))
    return np.asarray(dl), np.asarray(dg)


@pytest.mark.parametrize("lt,lx", [(2, 3), (4, 4), (6, 8)])
def test_torch_wilson_double_backward_reference_matches_jax(lt, lx):
    rng = np.random.default_rng(lt + 7 * lx)
    links = _links(lt + lx, 3, lt, lx)
    g = rng.uniform(1.0, 5.0, 3).astype(np.float32)
    w = rng.standard_normal(links.shape).astype(np.float32)
    want_dl, want_dg = _jax_force_vjp(links, g, w)
    dl, dg = tw.wilson_double_backward_reference(
        torch.from_numpy(links), torch.from_numpy(g), torch.from_numpy(w))
    np.testing.assert_allclose(dl.numpy(), want_dl, atol=1e-4)
    np.testing.assert_allclose(dg.numpy(), want_dg, atol=1e-4)


def test_torch_wilson_kernel_autograd_second_order_matches_jax():
    """The kernel path's autograd Functions (force recorded under
    ``create_graph``, its backward the double-backward kernel) give JAX's
    grad-of-grad, for the link and the per-chain cotangent inputs alike."""
    rng = np.random.default_rng(5)
    links = _links(5, 3, 4, 6)
    beta = rng.uniform(1.0, 4.0, 3).astype(np.float32)
    c = rng.standard_normal(links.shape).astype(np.float32)

    def inner_j(l, bb):
        f = jax.grad(lambda y: jnp.sum(bb * jw.wilson_action(y)))(l)
        return jnp.sum(jnp.asarray(c) * f)

    want_l, want_b = jax.grad(inner_j, argnums=(0, 1))(jnp.asarray(links),
                                                       jnp.asarray(beta))
    for action in (tw.wilson_action_kernel, tw.wilson_action):
        x = torch.from_numpy(links).requires_grad_(True)
        b = torch.from_numpy(beta).requires_grad_(True)
        (f,) = torch.autograd.grad(torch.sum(b * action(x)), x,
                                   create_graph=True)
        gl, gb = torch.autograd.grad(torch.sum(torch.from_numpy(c) * f),
                                     (x, b))
        np.testing.assert_allclose(gl.numpy(), np.asarray(want_l), atol=1e-4)
        np.testing.assert_allclose(gb.numpy(), np.asarray(want_b), atol=1e-4)


def _launch_counts():
    return tuple(f.launches for f in (
        tw.wilson_forward, tw.wilson_action_only, tw.wilson_backward,
        tw.wilson_force, tw.wilson_double_backward))


def test_torch_wilson_wrappers_on_cpu_run_the_plain_versions():
    """CPU tensors take the plain versions and launch nothing; the flat
    potential routes CPU states to the plain Function and keeps the graph
    for a second derivative."""
    from l2hmc_tpu_torch.lattice.u1 import LatticeShape

    counts = _launch_counts()
    links = torch.from_numpy(_links(9))
    s, sinp = tw.wilson_forward(links)
    s_r, sinp_r = tw.wilson_forward_reference(links)
    assert torch.equal(s, s_r) and torch.equal(sinp, sinp_r)
    assert torch.equal(tw.wilson_action_only(links), s_r)
    g = torch.full((4,), 2.0)
    assert torch.equal(tw.wilson_backward(sinp, g),
                       tw.wilson_backward_reference(sinp, g))
    assert torch.equal(tw.wilson_force(links, g),
                       tw.wilson_force_reference(links, g))
    w = torch.randn(links.shape, generator=torch.Generator().manual_seed(0))
    for a, b in zip(tw.wilson_double_backward(links, g, w),
                    tw.wilson_double_backward_reference(links, g, w)):
        assert torch.equal(a, b)
    pot = tw.make_potential_fn(LatticeShape(4, 6))
    x = links.reshape(4, -1).clone().requires_grad_(True)
    (f,) = torch.autograd.grad(pot(x).sum(), x, create_graph=True)
    assert f.requires_grad
    np.testing.assert_allclose(
        pot(x).detach().numpy(),
        tw.make_plain_potential_fn(LatticeShape(4, 6))(x).detach().numpy())
    assert counts == _launch_counts()
    with pytest.raises(ValueError, match="Lt, Lx >= 2"):
        tw.wilson_forward(torch.zeros(2, 1, 4, 2))


# ---------------------------------------------------------------------------
# The fused force, its autograd Function and the routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lt,lx", [(2, 2), (4, 6), (8, 8), (3, 5)])
def test_torch_wilson_force_reference_matches_jax(lt, lx):
    """The fused force's plain version against JAX's gradient of ``sum(g *
    S)`` through the interpret-mode Pallas kernel, per-chain ``g``."""
    rng = np.random.default_rng(100 * lt + lx)
    links = _links(lt * 7 + lx, 3, lt, lx)
    g = rng.uniform(1.0, 5.0, 3).astype(np.float32)
    want = np.asarray(jax.grad(lambda l: jnp.sum(
        jnp.asarray(g) * jw.wilson_action_pallas(l, interpret=True)))(
            jnp.asarray(links)))
    got = tw.wilson_force_reference(torch.from_numpy(links),
                                    torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_torch_wilson_force_fn_second_order_matches_jax():
    """:class:`WilsonForceFn` on CPU tensors (forward: the fused force's
    plain version; backward: the double backward's) gives JAX's force and
    its grad-of-grad for the link and the ``beta`` cotangents; so does the
    potential's ``force`` with a per-chain and with a scalar tensor
    ``beta``."""
    from l2hmc_tpu_torch.lattice.u1 import LatticeShape

    rng = np.random.default_rng(15)
    links = _links(15, 3, 4, 6)
    beta = rng.uniform(1.0, 4.0, 3).astype(np.float32)
    c = rng.standard_normal(links.shape).astype(np.float32)

    def force_j(l, bb):
        return jax.grad(lambda y: jnp.sum(bb * jw.wilson_action(y)))(l)

    def inner_j(l, bb):
        return jnp.sum(jnp.asarray(c) * force_j(l, bb))

    jl = jnp.asarray(links)
    for b_np in (beta, beta[:1].reshape(())):
        jb = jnp.asarray(b_np)
        want_f = np.asarray(force_j(jl, jb))
        want_l, want_b = jax.grad(inner_j, argnums=(0, 1))(jl, jb)
        pot = tw.make_potential_fn(LatticeShape(4, 6))
        runs = {"potential force": lambda x, b: pot.force(
            x.reshape(3, -1), b).reshape(x.shape)}
        if b_np.ndim == 1:
            runs["WilsonForceFn"] = tw.WilsonForceFn.apply
        for name, fn in runs.items():
            x = torch.from_numpy(links).requires_grad_(True)
            b = torch.from_numpy(b_np).requires_grad_(True)
            f = fn(x, b)
            gl, gb = torch.autograd.grad(torch.sum(torch.from_numpy(c) * f),
                                         (x, b))
            np.testing.assert_allclose(f.detach().numpy(), want_f,
                                       atol=1e-5, err_msg=name)
            np.testing.assert_allclose(gl.numpy(), np.asarray(want_l),
                                       atol=1e-4, err_msg=name)
            np.testing.assert_allclose(gb.numpy(), np.asarray(want_b),
                                       atol=1e-4, err_msg=name)


# (b, lt, lx) -> route: the shapes of chip_smoke.py's phase 6 and of
# tests/test_torch_kernels.py's card tests
PLAN_CASES = {
    (128, 16, 16): "block", (2048, 16, 16): "block",
    (1056, 16, 16): "block", (1055, 16, 16): "block",
    (512, 16, 16): "block", (7, 16, 16): "block",
    (3, 32, 32): "block", (2048, 32, 32): "block",
    (3, 2, 2): "block", (4096, 2, 2): "block",
    (1, 3, 37): "block", (512, 64, 64): "block",
    (2, 64, 64): "block", (2, 128, 128): "block",
    (8, 128, 128): "block", (1, 160, 160): "global",
}


@pytest.mark.parametrize("shape", sorted(PLAN_CASES))
def test_torch_wilson_plan(shape):
    """Route, threads and shared memory per kernel: one block per chain, a
    thread per site up to 512; the block route while a chain's links and
    one field fit 227 KB, the global route beyond; on the block route the
    force and the double backward stage links and a field, the backward
    its sin P from 64x64 up, the forward kinds nothing; every block within
    the card's shared memory.  Any lattice may be forced onto the global
    route, none beyond the block route's limit onto it; a forced route is
    every kernel's."""
    b, lt, lx = shape
    d = lt * lx
    plan = tw.wilson_plan(b, lt, lx)
    assert plan.route == PLAN_CASES[shape]
    assert plan.threads == min(512, -(-d // 32) * 32)
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    tiles = {"forward": 0, "action_only": 0, "force": r4(2 * d) + r4(d),
             "backward": r4(d), "double_backward": r4(2 * d) + r4(d)}
    assert set(plan.smem) == set(plan.routes) == set(tw.WILSON_KINDS)
    for kind, nbytes in plan.smem.items():
        staged = plan.routes[kind] == "block"
        assert plan.routes[kind] == (
            "global" if kind == "backward" and d < 4096 else plan.route)
        assert nbytes == (4 * tiles[kind] if staged else 0), kind
        assert nbytes + tw.WILSON_STATIC_SMEM <= 227 * 1024
    assert (4 * tiles["force"] + tw.WILSON_STATIC_SMEM <= 227 * 1024) == (
        plan.route == "block")
    glob = tw.wilson_plan(b, lt, lx, "global")
    assert set(glob.routes.values()) == {"global"}
    assert not any(glob.smem.values())
    if plan.route == "global":
        with pytest.raises(ValueError, match="route 'block'"):
            tw.wilson_plan(b, lt, lx, "block")
    else:
        block = tw.wilson_plan(b, lt, lx, "block")
        assert set(block.routes.values()) == {"block"}
        assert block.smem["backward"] == 4 * tiles["backward"]
    with pytest.raises(ValueError, match="route 'warp'"):
        tw.wilson_plan(b, lt, lx, "warp")


def _cpu_dynamics(pot):
    from l2hmc_tpu_torch.train import gauge as tgauge

    cfg = tgauge.GaugeConfig(time_size=4, space_size=6, num_chains=5,
                             num_steps=3, network_arch="mlp", num_hidden=16,
                             merge_v_halves=True, eps_init=0.15)
    params = tgauge.init_params(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    with torch.no_grad():
        gen = torch.Generator().manual_seed(4)
        for net in (params.xnet, params.vnet):
            for q in net.parameters():
                q.add_(0.05 * torch.randn(q.shape, generator=gen))
    return cfg, params, tgauge.build_dynamics(cfg, pot)[1]


def test_torch_wilson_force_potential_drives_the_dynamics_like_autograd():
    """The dynamics' ``grad_potential`` (first force without a graph, the
    later ones under ``create_graph``: the trajectory's x depends on the
    params) and ``hmc._grad`` with the potential's ``force``, against the
    autograd path on the plain potential: trajectory, log-Jacobian and the
    params' gradient through the forces' backward."""
    from l2hmc_tpu_torch.dynamics import hmc as thmc
    from l2hmc_tpu_torch.lattice.u1 import LatticeShape

    shape = LatticeShape(4, 6)
    rng = np.random.default_rng(21)
    x = torch.tensor(_links(21, 5, 4, 6).reshape(5, -1))
    v = torch.tensor(rng.standard_normal(x.shape), dtype=torch.float32)
    direction = torch.tensor([1.0, -1.0, 1.0, -1.0, 1.0])
    c = torch.tensor(rng.standard_normal(x.shape), dtype=torch.float32)
    pots = {"force": tw.make_potential_fn(shape),
            "autograd": tw.make_plain_potential_fn(shape)}
    assert hasattr(pots["force"], "force")
    assert not hasattr(pots["autograd"], "force")
    out = {}
    for name, pot in pots.items():
        cfg, params, dyn = _cpu_dynamics(pot)
        xo, vo, ld = dyn["integrate"](params, x, v, 2.5, direction)
        loss = torch.sum(c * xo) + torch.sum(c * vo) + torch.sum(ld)
        wrt = [q for q in list(params.xnet.parameters())
               + list(params.vnet.parameters())]
        grads = torch.autograd.grad(loss, wrt)
        hmc_x, hmc_v = thmc.leapfrog(pot, x, v, 2.5, 0.1, 3)
        g_hmc = thmc._grad(pot, x.clone().requires_grad_(True), 2.5)
        assert not g_hmc.requires_grad
        out[name] = [xo.detach(), vo.detach(), ld.detach(), *grads, hmc_x,
                     hmc_v, g_hmc]
    for a, b in zip(out["force"], out["autograd"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
