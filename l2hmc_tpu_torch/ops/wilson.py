"""Wilson action with its analytic gradient (port of ``l2hmc_tpu/ops/wilson.py``).

The gradient of the Wilson action shares the plaquette computation with the
forward pass::

    P(t,x)        = u0 - u1 - roll(u0,-1,x) + roll(u1,-1,t)
    S             = sum(1 - cos P)
    dS/du0(t,x)   =  sin P(t,x) - sin P(t,x-1)
    dS/du1(t,x)   = -sin P(t,x) + sin P(t-1,x)

:class:`WilsonAction` saves ``sin P`` and forms the backward from it with
differentiable torch ops, so a second derivative (the training loss
differentiates through the force) is available through autograd.

This module holds the plain form only.  The reference's Pallas kernel for
this function (``wilson_action_pallas``) is not on the sampling path and is
still to be ported.
"""

from __future__ import annotations

import torch


def _plaq_sums(u0: torch.Tensor, u1: torch.Tensor) -> torch.Tensor:
    return u0 - u1 - torch.roll(u0, -1, dims=-1) + torch.roll(u1, -1, dims=-2)


def _grad_from_sinp(sinp: torch.Tensor) -> torch.Tensor:
    """Analytic dS/dlinks ``(..., Lt, Lx, 2)`` from the sin-plaquette field."""
    g0 = sinp - torch.roll(sinp, 1, dims=-1)    # sin P(t,x) - sin P(t,x-1)
    g1 = -sinp + torch.roll(sinp, 1, dims=-2)   # -sin P(t,x) + sin P(t-1,x)
    return torch.stack([g0, g1], dim=-1)


class WilsonAction(torch.autograd.Function):
    """``links (..., Lt, Lx, 2) -> (...,)`` total Wilson action per sample."""

    @staticmethod
    def forward(ctx, links):
        p = _plaq_sums(links[..., 0], links[..., 1])
        ctx.save_for_backward(links, torch.sin(p))
        return torch.sum(1.0 - torch.cos(p), dim=(-2, -1))

    @staticmethod
    def backward(ctx, g):
        links, sinp = ctx.saved_tensors
        if torch.is_grad_enabled():
            # create_graph=True: the saved sin P carries no graph, so
            # recompute it from the links with differentiable ops and the
            # backward itself has a backward (double differentiation)
            sinp = torch.sin(_plaq_sums(links[..., 0], links[..., 1]))
        return g[..., None, None, None] * _grad_from_sinp(sinp)


def wilson_action(links: torch.Tensor) -> torch.Tensor:
    """Total Wilson action per sample with the analytic backward."""
    return WilsonAction.apply(links)


def make_potential_fn(shape):
    """Flat-state potential ``U(x) -> per-sample S`` on the analytic path."""

    def potential(x: torch.Tensor) -> torch.Tensor:
        links = x.reshape(*x.shape[:-1], *shape.links_shape)
        return wilson_action(links)

    return potential
