"""PyTorch port, ops/wilson.py: the Wilson action's three kernels' plain
versions and the kernel path's autograd wiring against JAX.

The JAX side is the reference's Pallas kernel run in interpret mode
(``wilson_action_pallas(..., interpret=True)``, as tests/test_ops.py runs
it) for the value and the gradient, and the analytic-VJP ``wilson_action``
differentiated twice for the force's backward (JAX forms that derivative in
XLA, outside any Pallas kernel).  On CPU tensors the kernel wrappers run
their plain versions, so :class:`WilsonActionKernel` is exercised here with
the same formulas the CUDA kernels implement; the kernels themselves are
held against these plain versions on the card (tests/test_torch_kernels.py).

Tolerances: S to rtol 1e-5 (float32 sums of up to 64 terms in another
order), first and second derivatives to atol 1e-5 / 1e-4 (O(1) entries,
different libm sin/cos and summation order).
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


def test_torch_wilson_wrappers_on_cpu_run_the_plain_versions():
    """CPU tensors take the plain versions and launch nothing; the flat
    potential routes CPU states to the plain Function and keeps the graph
    for a second derivative."""
    from l2hmc_tpu_torch.lattice.u1 import LatticeShape

    counts = (tw.wilson_forward.launches, tw.wilson_backward.launches,
              tw.wilson_double_backward.launches)
    links = torch.from_numpy(_links(9))
    s, sinp = tw.wilson_forward(links)
    s_r, sinp_r = tw.wilson_forward_reference(links)
    assert torch.equal(s, s_r) and torch.equal(sinp, sinp_r)
    g = torch.full((4,), 2.0)
    assert torch.equal(tw.wilson_backward(sinp, g),
                       tw.wilson_backward_reference(sinp, g))
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
    assert counts == (tw.wilson_forward.launches, tw.wilson_backward.launches,
                      tw.wilson_double_backward.launches)
    with pytest.raises(ValueError, match="Lt, Lx >= 2"):
        tw.wilson_forward(torch.zeros(2, 1, 4, 2))
