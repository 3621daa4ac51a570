"""Wilson action with its analytic gradient (port of ``l2hmc_tpu/ops/wilson.py``).

The gradient of the Wilson action shares the plaquette computation with the
forward pass::

    P(t,x)        = u0 - u1 - roll(u0,-1,x) + roll(u1,-1,t)
    S             = sum(1 - cos P)
    dS/du0(t,x)   =  sin P(t,x) - sin P(t,x-1)
    dS/du1(t,x)   = -sin P(t,x) + sin P(t-1,x)

Training differentiates through the force (the leapfrog uses it), so the
force needs a backward too: for a cotangent ``w`` on ``g * dS/dlinks``::

    r      = w0 - roll(w0,-1,x) - w1 + roll(w1,-1,t)
    h      = g cos P r
    dlinks = (h - roll(h,1,x), -h + roll(h,1,t)),   dg = sum(r sin P)

Two forms of one function:

- :class:`WilsonAction`, the plain version: torch ops, ``sin P`` saved, the
  backward built from differentiable ops so that autograd forms the second
  derivative itself.
- :class:`WilsonActionKernel` over :class:`WilsonForceKernel`: the forward
  (:func:`wilson_forward`), the force (:func:`wilson_backward`) and the
  force's backward (:func:`wilson_double_backward`) are the three kernels of
  ``csrc/wilson.cu`` (the port of the reference's ``wilson_action_pallas``).
  Each wrapper launches its kernel for CUDA tensors, or raises, and runs
  its plain version (``*_reference``) for CPU tensors.

:func:`make_potential_fn` sends CUDA states through the kernels and CPU
states through the plain version.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops.leapfrog import check_cuda_input


def _plaq_sums(u0: torch.Tensor, u1: torch.Tensor) -> torch.Tensor:
    return u0 - u1 - torch.roll(u0, -1, dims=-1) + torch.roll(u1, -1, dims=-2)


def _grad_from_sinp(sinp: torch.Tensor) -> torch.Tensor:
    """Analytic dS/dlinks ``(..., Lt, Lx, 2)`` from the sin-plaquette field."""
    g0 = sinp - torch.roll(sinp, 1, dims=-1)    # sin P(t,x) - sin P(t,x-1)
    g1 = -sinp + torch.roll(sinp, 1, dims=-2)   # -sin P(t,x) + sin P(t-1,x)
    return torch.stack([g0, g1], dim=-1)


def wilson_forward_reference(links):
    """``links (..., Lt, Lx, 2) -> (S (...,), sin P (..., Lt, Lx))``: the
    forward kernel's plain version."""
    p = _plaq_sums(links[..., 0], links[..., 1])
    return torch.sum(1.0 - torch.cos(p), dim=(-2, -1)), torch.sin(p)


def wilson_backward_reference(sinp, g):
    """The force ``g dS/dlinks (..., Lt, Lx, 2)`` from ``sin P`` and
    ``g (...,)``: the backward kernel's plain version."""
    return g[..., None, None, None] * _grad_from_sinp(sinp)


def wilson_double_backward_reference(links, g, w):
    """``(dlinks, dg)``: the backward of the force for its cotangent
    ``w (B, Lt, Lx, 2)``; the double-backward kernel's plain version."""
    p = _plaq_sums(links[..., 0], links[..., 1])
    w0, w1 = w[..., 0], w[..., 1]
    r = w0 - torch.roll(w0, -1, dims=-1) - w1 + torch.roll(w1, -1, dims=-2)
    h = g[:, None, None] * torch.cos(p) * r
    dlinks = torch.stack([h - torch.roll(h, 1, dims=-1),
                          -h + torch.roll(h, 1, dims=-2)], dim=-1)
    return dlinks, torch.sum(r * torch.sin(p), dim=(-2, -1))


class WilsonAction(torch.autograd.Function):
    """``links (..., Lt, Lx, 2) -> (...,)`` total Wilson action per sample."""

    @staticmethod
    def forward(ctx, links):
        action, sinp = wilson_forward_reference(links)
        ctx.save_for_backward(links, sinp)
        return action

    @staticmethod
    def backward(ctx, g):
        links, sinp = ctx.saved_tensors
        if torch.is_grad_enabled():
            # create_graph=True: the saved sin P carries no graph, so
            # recompute it from the links with differentiable ops and the
            # backward itself has a backward (double differentiation)
            sinp = torch.sin(_plaq_sums(links[..., 0], links[..., 1]))
        return wilson_backward_reference(sinp, g)


def wilson_action(links: torch.Tensor) -> torch.Tensor:
    """Total Wilson action per sample with the analytic backward (plain)."""
    return WilsonAction.apply(links)


# ---------------------------------------------------------------------------
# The three kernels of csrc/wilson.cu: wrappers (plain versions above)
# ---------------------------------------------------------------------------


def _links_dims(links):
    if links.dim() != 4 or links.shape[-1] != 2 or min(links.shape[1:3]) < 2:
        raise ValueError("links: expected shape (B, Lt, Lx, 2) with Lt, Lx "
                         f">= 2, got {tuple(links.shape)}")
    return links.shape[:3]


def wilson_forward(links):
    """``(S (B,), sin P (B, Lt, Lx))`` of ``links (B, Lt, Lx, 2)``: the
    forward kernel for a CUDA tensor, the plain version for a CPU one."""
    b, lt, lx = _links_dims(links)
    if not links.is_cuda:
        return wilson_forward_reference(links)
    check_cuda_input("links", links, (b, lt, lx, 2))
    action = torch.empty((b,), dtype=torch.float32, device=links.device)
    sinp = torch.empty((b, lt, lx), dtype=torch.float32, device=links.device)
    wilson_forward.launches += 1
    _cuda.check(_cuda.library().wilson_fwd_launch(
        links.data_ptr(), action.data_ptr(), sinp.data_ptr(), b, lt, lx,
        links.device.index or 0, _cuda.stream_handle(links.device)),
        "wilson_fwd_launch")
    return action, sinp


def wilson_backward(sinp, g):
    """The force ``g dS/dlinks (B, Lt, Lx, 2)`` from ``sin P (B, Lt, Lx)``
    and ``g (B,)``: the backward kernel for CUDA tensors."""
    if not sinp.is_cuda:
        return wilson_backward_reference(sinp, g)
    if sinp.dim() != 3:
        raise ValueError("sinp: expected shape (B, Lt, Lx), got "
                         f"{tuple(sinp.shape)}")
    b, lt, lx = sinp.shape
    check_cuda_input("sinp", sinp, (b, lt, lx))
    check_cuda_input("g", g, (b,))
    force = torch.empty((b, lt, lx, 2), dtype=torch.float32,
                        device=sinp.device)
    wilson_backward.launches += 1
    _cuda.check(_cuda.library().wilson_bwd_launch(
        sinp.data_ptr(), g.data_ptr(), force.data_ptr(), b, lt, lx,
        sinp.device.index or 0, _cuda.stream_handle(sinp.device)),
        "wilson_bwd_launch")
    return force


def wilson_double_backward(links, g, w):
    """``(dlinks (B, Lt, Lx, 2), dg (B,))`` for the cotangent ``w`` on the
    force: the double-backward kernel for CUDA tensors."""
    b, lt, lx = _links_dims(links)
    if not links.is_cuda:
        return wilson_double_backward_reference(links, g, w)
    check_cuda_input("links", links, (b, lt, lx, 2))
    check_cuda_input("g", g, (b,))
    check_cuda_input("w", w, (b, lt, lx, 2))
    dlinks = torch.empty_like(links)
    dg = torch.empty((b,), dtype=torch.float32, device=links.device)
    wilson_double_backward.launches += 1
    _cuda.check(_cuda.library().wilson_bwd_bwd_launch(
        links.data_ptr(), g.data_ptr(), w.data_ptr(), dlinks.data_ptr(),
        dg.data_ptr(), b, lt, lx, links.device.index or 0,
        _cuda.stream_handle(links.device)), "wilson_bwd_bwd_launch")
    return dlinks, dg


wilson_forward.launches = 0
wilson_backward.launches = 0
wilson_double_backward.launches = 0


class WilsonForceKernel(torch.autograd.Function):
    """``(links, sinp, g) -> g dS/dlinks``; differentiable in ``links`` and
    ``g`` through :func:`wilson_double_backward` (``sinp`` is the forward's
    residual, a function of ``links`` that the double backward accounts
    for)."""

    @staticmethod
    def forward(ctx, links, sinp, g):
        ctx.save_for_backward(links, g)
        return wilson_backward(sinp, g)

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        links, g = ctx.saved_tensors
        dlinks, dg = wilson_double_backward(links, g, w.contiguous())
        return dlinks, None, dg


class WilsonActionKernel(torch.autograd.Function):
    """``links (B, Lt, Lx, 2) -> (B,)`` on the kernels of ``csrc/wilson.cu``;
    its backward is :class:`WilsonForceKernel`, so a ``create_graph=True``
    gradient records the force and a later backward reaches the
    Hessian-vector product."""

    @staticmethod
    def forward(ctx, links):
        action, sinp = wilson_forward(links)
        ctx.save_for_backward(links, sinp)
        return action

    @staticmethod
    def backward(ctx, g):
        links, sinp = ctx.saved_tensors
        return WilsonForceKernel.apply(links, sinp, g.contiguous())


def wilson_action_kernel(links: torch.Tensor) -> torch.Tensor:
    """Total Wilson action per sample on the kernel path; ``links (...,
    Lt, Lx, 2)`` with any leading dims."""
    lead = links.shape[:-3]
    flat = links.reshape(-1, *links.shape[-3:]).contiguous()
    return WilsonActionKernel.apply(flat).reshape(lead)


def make_potential_fn(shape):
    """Flat-state potential ``U(x) -> per-sample S``: CUDA states go through
    the kernels of ``csrc/wilson.cu``, CPU states through the plain
    :class:`WilsonAction`."""

    def potential(x: torch.Tensor) -> torch.Tensor:
        links = x.reshape(*x.shape[:-1], *shape.links_shape)
        if links.is_cuda:
            return wilson_action_kernel(links)
        return wilson_action(links)

    return potential


def make_plain_potential_fn(shape):
    """Flat-state potential on the plain :class:`WilsonAction` for any
    device (the yardstick the kernels are held against on the card)."""

    def potential(x: torch.Tensor) -> torch.Tensor:
        return wilson_action(x.reshape(*x.shape[:-1], *shape.links_shape))

    return potential
