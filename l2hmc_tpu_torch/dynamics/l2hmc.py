"""L2HMC augmented-leapfrog transition (port of ``l2hmc_tpu/dynamics/l2hmc.py``).

Restricted to the champion family: ``group='u1'`` (periodic cos/sin network
features, circle-diffeomorphism position scaling with exact log-Jacobian),
``merge_v_halves`` (K+1 momentum kicks per trajectory), one fused
integration per chain with a random per-chain direction, and the ``hmc``
zero-net mode.  Other settings raise ``NotImplementedError``.

Update equations (per direction-fused sub-step; see the reference module)::

    v' = v * exp(f eps/2 s) - f eps/2 (exp(eps q) g - t)        (kick)
    x' = m x + (1-m) wrap(circle_scale(x, eps s) + eps (exp(eps q) v + t))
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from l2hmc_tpu_torch.lattice.u1 import wrap as _wrap
from l2hmc_tpu_torch.ops.l2hmc_kernel import _circle_scale as circle_scale

PotentialFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    """Static configuration of the augmented leapfrog kernel."""

    x_dim: int
    num_steps: int = 5
    eps_trainable: bool = True
    hmc: bool = False                 # zero the nets -> plain HMC
    use_log_eps: bool = False         # eps = exp(alpha)
    both_directions: bool = False
    remat: bool = True
    group: str = "r1"
    eps_cap: float = 0.0
    merge_v_halves: bool = False


class DynamicsParams(nn.Module):
    """Trainable + fixed state of the dynamics: the two conditioners, the
    step size (``raw_eps``) and the ``(num_steps, x_dim)`` hold-masks."""

    def __init__(self, xnet: nn.Module, vnet: nn.Module,
                 raw_eps: torch.Tensor, masks: torch.Tensor):
        super().__init__()
        self.xnet = xnet
        self.vnet = vnet
        self.raw_eps = nn.Parameter(torch.as_tensor(raw_eps,
                                                    dtype=torch.float32))
        self.register_buffer("masks", torch.as_tensor(masks,
                                                      dtype=torch.float32))


class Transition(NamedTuple):
    """Outputs of one MH transition."""

    x_proposed: torch.Tensor
    v_proposed: torch.Tensor
    accept_prob: torch.Tensor
    x_out: torch.Tensor
    sumlogdet: torch.Tensor
    accept_mask: torch.Tensor
    forward_frac: torch.Tensor


def make_masks(generator, num_steps: int, x_dim: int, device=None):
    """Per-step binary masks with exactly ``x_dim // 2`` ones."""
    rows = [(torch.randperm(x_dim, generator=generator, device=device)
             < x_dim // 2).to(torch.float32) for _ in range(num_steps)]
    return torch.stack(rows)


def time_encoding(step_idx: torch.Tensor, num_steps: int) -> torch.Tensor:
    """``[cos(2 pi i/K), sin(2 pi i/K)]``; ``(batch,) -> (batch, 2)``."""
    ang = 2.0 * np.pi * step_idx.to(torch.float32) / num_steps
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def get_eps(params: DynamicsParams, cfg: DynamicsConfig) -> torch.Tensor:
    eps = torch.exp(params.raw_eps) if cfg.use_log_eps else params.raw_eps
    if cfg.eps_cap > 0:
        eps = torch.clamp(eps, max=cfg.eps_cap)
    return eps


def _check_supported(cfg: DynamicsConfig):
    unported = {
        "group='r1'": cfg.group != "u1",
        "the split integrator (merge_v_halves=False)": not cfg.merge_v_halves,
        "both_directions": cfg.both_directions,
        "use_log_eps": cfg.use_log_eps,
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(
                f"DynamicsConfig: {what} is not ported yet (ROADMAP queue A "
                f"item 3, the rest of dynamics/l2hmc.py)")


def make_dynamics(cfg: DynamicsConfig, potential_fn: PotentialFn):
    """Build the transition functions for a target potential.

    The conditioners are the ``params.xnet``/``params.vnet`` modules
    (``forward(v, x, t) -> (S, T, Q)``).  Returns a dict of functions:

    ``transition(params, x, beta, generator) -> Transition``
    ``transition_with(params, x, beta, v, direction, u) -> Transition``
        (injected randomness: momenta ``v (B, x_dim)``, ``direction (B,)``
        in {+1,-1}, accept uniforms ``u (B,)``)
    ``integrate(params, x, v, beta, direction) -> (x', v', sumlogdet)``
    ``hamiltonian``, ``potential_energy``, ``kinetic_energy``, ``accept_prob``.

    ``cfg.remat`` is accepted and has no effect: it selects activation
    checkpointing of the trajectory in the reference, which saves memory
    in training only at large width (hidden ~4096).
    """
    _check_supported(cfg)
    K = cfg.num_steps

    if cfg.hmc:
        def zero_net(net, v, x, t):
            z = torch.zeros((v.shape[0], cfg.x_dim), dtype=v.dtype,
                            device=v.device)
            return z, z, z
        apply_net = zero_net
    else:
        def apply_net(net, v, x, t):
            return net(v, x, t)

    def potential_energy(x, beta):
        return beta * potential_fn(x)

    def kinetic_energy(v):
        return 0.5 * torch.sum(v * v, dim=-1)

    def hamiltonian(x, v, beta):
        return potential_energy(x, beta) + kinetic_energy(v)

    force = getattr(potential_fn, "force", None)

    def grad_potential(x, beta):
        """d/dx [beta U(x)]; keeps the graph when x is part of one.  A
        potential with a ``force`` (``ops/wilson.py make_potential_fn``)
        gives it in one call; otherwise autograd differentiates U."""
        if force is not None:
            with torch.set_grad_enabled(x.requires_grad):
                return force(x, beta)
        with torch.enable_grad():
            xg = x if x.requires_grad else x.detach().requires_grad_(True)
            e = torch.sum(potential_energy(xg, beta))
            (g,) = torch.autograd.grad(e, xg, create_graph=x.requires_grad)
        return g

    def pos_features(x, mask=None):
        feats = torch.cat([torch.cos(x), torch.sin(x)], dim=-1)
        if mask is not None:
            feats = torch.cat([mask, mask], dim=-1) * feats
        return feats

    def update_v(params, x, v, g, tau, d_col, d_row, eps, factor=0.5):
        """Direction-fused momentum kick (``factor`` x eps)."""
        s, t, q = apply_net(params.vnet, pos_features(x), g, tau)
        h_s = factor * eps * s
        a = factor * eps * (torch.exp(eps * q) * g - t)
        e = torch.exp(d_col * h_s)
        v_new = torch.where(d_col > 0, v * e - a, (v + a) * e)
        return v_new, d_row * torch.sum(h_s, dim=-1)

    def update_x(params, x, v, tau, hold_mask, d_col, eps):
        """Direction-fused position step on the torus; ``hold_mask`` part
        stays fixed."""
        s, t, q = apply_net(params.xnet, v, pos_features(x, hold_mask), tau)
        es = eps * s
        b = eps * (torch.exp(eps * q) * v + t)
        u = torch.where(d_col > 0, x, _wrap(x - b))
        y, ld = circle_scale(u, d_col * es)
        upd = torch.where(d_col > 0, _wrap(y + b), y)
        x_new = hold_mask * x + (1.0 - hold_mask) * upd
        return x_new, torch.sum((1.0 - hold_mask) * ld, dim=-1)

    def _step_context(params, step, d_row):
        """Each chain reads masks/time at ``step`` (forward) or ``K-1-step``
        (backward); forward X order is hold=m then 1-m, backward reversed."""
        d_col = d_row[:, None]
        idx = torch.where(d_row > 0, step, K - 1 - step).to(torch.int64)
        tau = time_encoding(idx, K)
        mask = params.masks[idx]
        hold1 = torch.where(d_col > 0, mask, 1.0 - mask)
        return d_col, tau, hold1, 1.0 - hold1

    def _integrate_merged(params, x, v, beta, direction):
        """``merge_v_halves`` trajectory: K+1 VNet calls instead of 2K."""
        eps = get_eps(params, cfg)
        d_col = direction[:, None]
        g = grad_potential(x, beta)
        sumlogdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for step in range(K):
            _, tau_x, hold1, hold2 = _step_context(params, step, direction)
            factor = 0.5 if step == 0 else 1.0
            t_fwd = 0.0 if step == 0 else step - 0.5
            t_bwd = K - 1.0 if step == 0 else K - 0.5 - step
            tau_v = time_encoding(torch.where(
                direction > 0, t_fwd, t_bwd), K)
            v, ld = update_v(params, x, v, g, tau_v, d_col, direction, eps,
                             factor=factor)
            sumlogdet = sumlogdet + ld
            x, ld = update_x(params, x, v, tau_x, hold1, d_col, eps)
            sumlogdet = sumlogdet + ld
            x, ld = update_x(params, x, v, tau_x, hold2, d_col, eps)
            sumlogdet = sumlogdet + ld
            g = grad_potential(x, beta)
        # closing half-kick: trajectory time K-1 forward, 0 backward
        tau_v = time_encoding(torch.where(direction > 0, K - 1.0, 0.0), K)
        v, ld = update_v(params, x, v, g, tau_v, d_col, direction, eps,
                         factor=0.5)
        return x, v, sumlogdet + ld

    def accept_prob_fn(x0, v0, x1, v1, sumlogdet, beta):
        """``exp(min(H0 - H1 + logdet, 0))`` with NaN -> 0."""
        dh = hamiltonian(x0, v0, beta) - hamiltonian(x1, v1, beta) + sumlogdet
        prob = torch.exp(torch.clamp(dh, max=0.0))
        return torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))

    def _sanitize(x, v, xp, vp):
        """Replace non-finite proposals with the initial state."""
        ok = torch.all(torch.isfinite(xp) & torch.isfinite(vp), dim=-1,
                       keepdim=True)
        return torch.where(ok, xp, x), torch.where(ok, vp, v)

    def transition_with(params, x, beta, v, direction, u):
        xp, vp, sumlogdet = _integrate_merged(params, x, v, beta, direction)
        prob = accept_prob_fn(x, v, xp, vp, sumlogdet, beta)
        xp, vp = _sanitize(x, v, xp, vp)
        accept = (u < prob).to(x.dtype)
        x_out = accept[:, None] * xp + (1.0 - accept[:, None]) * x
        return Transition(
            x_proposed=xp, v_proposed=vp, accept_prob=prob, x_out=x_out,
            sumlogdet=sumlogdet, accept_mask=accept,
            forward_frac=torch.mean((direction > 0).to(torch.float32)))

    def _transition_fused(params, x, beta, generator):
        v = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=x.device)
        direction = torch.where(
            torch.rand((x.shape[0],), generator=generator,
                       device=x.device) > 0.5, 1.0, -1.0).to(x.dtype)
        u = torch.rand((x.shape[0],), generator=generator, device=x.device)
        return transition_with(params, x, beta, v, direction, u)

    def chain_operator(*args, **kwargs):
        raise NotImplementedError(
            "chain_operator is not ported yet (ROADMAP queue A item 14, "
            "the VAE slice)")

    return {
        "chain_operator": chain_operator,
        "transition": _transition_fused,
        "transition_with": transition_with,
        "integrate": _integrate_merged,
        "hamiltonian": hamiltonian,
        "potential_energy": potential_energy,
        "kinetic_energy": kinetic_energy,
        "accept_prob": accept_prob_fn,
    }
