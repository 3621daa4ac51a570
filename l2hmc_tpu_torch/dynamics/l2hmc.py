"""L2HMC augmented-leapfrog transition (port of ``l2hmc_tpu/dynamics/l2hmc.py``).

Every setting of the reference's :class:`DynamicsConfig`: ``group='u1'``
(periodic cos/sin network features, circle-diffeomorphism position scaling
with exact log-Jacobian) or ``'r1'`` (raw features, the flat
``x exp(eps s) + eps (exp(eps q) v + t)`` update); the split integrator
(2K momentum half-kicks per trajectory, the potential gradient cached
across steps: K+1 forces) or ``merge_v_halves`` (K+1 kicks); one fused
integration per chain with a random per-chain direction, or
``both_directions`` (forward and backward from the same momenta, one
picked per chain); ``use_log_eps``; ``hmc`` zero nets; and ``remat``,
activation checkpointing of each leapfrog step while autograd records.

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
from torch.utils.checkpoint import checkpoint

from l2hmc_tpu_torch.lattice.u1 import chain_total
from l2hmc_tpu_torch.lattice.u1 import wrap as _wrap
from l2hmc_tpu_torch.ops.l2hmc_kernel import _circle_scale as circle_scale
from l2hmc_tpu_torch.utils import trace

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


def make_dynamics(cfg: DynamicsConfig, potential_fn: PotentialFn,
                  sharding=None):
    """Build the transition functions for a target potential.

    The conditioners are the ``params.xnet``/``params.vnet`` modules
    (``forward(v, x, t) -> (S, T, Q)``).  Returns a dict of functions:

    ``transition(params, x, beta, generator, aux=None) -> Transition``
    ``transition_with(params, x, beta, v, direction, u, aux=None)``
        (injected randomness: momenta ``v (B, x_dim)``, ``direction (B,)``
        in {+1,-1}, accept uniforms ``u (B,)``; with ``both_directions``
        ``direction > 0`` is the per-chain coin that keeps the forward
        trajectory)
    ``chain_operator(params, x, beta, generator, max_compositions,
    aux=None)`` and ``chain_operator_with(params, x, beta,
    max_compositions, n_comp, v, direction, u, aux=None)``: ``n_comp (B,)``
    integrations, one accept
    ``integrate(params, x, v, beta, direction, aux=None) -> (x', v',
    sumlogdet)``
    ``hamiltonian``, ``potential_energy``, ``kinetic_energy``, ``accept_prob``.

    ``aux (B, aux_dim)`` conditions both nets (the VAE's data batch); the
    nets must have been built with ``aux_dim``.

    ``cfg.remat`` wraps each leapfrog step in ``torch.utils.checkpoint``
    (non-reentrant) while autograd records, as the reference wraps it in
    ``jax.checkpoint``: the step's activations are recomputed in the
    backward pass instead of kept, which re-runs the step's forces (and,
    sharded, their halo exchanges, in the same order on every rank).

    Spans (``utils/trace.py``): ``l2hmc.vnet`` and ``l2hmc.xnet`` around
    each conditioner call (features included), ``l2hmc.force`` around each
    potential gradient.

    ``sharding`` (``parallel/spatial.py``, bound to the lattice): ``x``,
    ``v`` and every per-link tensor are this rank's slab columns, the nets
    run their ``forward_sharded``, ``potential_fn`` must be a slab
    potential (the whole lattice's action per chain), and the per-chain
    sums (kinetic energy, log-dets, the finite test) are added over
    'space'; ``u``, ``direction`` and every per-chain output are
    replicated over it.  ``draw`` draws the global momenta and keeps the
    slab's columns, so a sharded run repeats the one-process run.
    """
    K = cfg.num_steps
    sp = sharding
    x_dim = cfg.x_dim if sp is None else sp.x_dim

    def chain_sum(t):
        """Per-chain sum over the last axis, whole-lattice when sharded."""
        return chain_total(torch.sum(t, dim=-1), sp)
    periodic = cfg.group == "u1"
    if cfg.group not in ("u1", "r1"):
        raise ValueError(f"group={cfg.group!r}")

    if cfg.hmc:
        def zero_net(net, v, x, t, aux):
            z = torch.zeros((v.shape[0], x_dim), dtype=v.dtype,
                            device=v.device)
            return z, z, z
        apply_net = zero_net
    elif sp is not None:
        def apply_net(net, v, x, t, aux):
            if aux is None:
                return net.forward_sharded(v, x, t, sp)
            return net.forward_sharded(v, x, t, sp, aux)
    else:
        def apply_net(net, v, x, t, aux):
            return net(v, x, t) if aux is None else net(v, x, t, aux)

    def potential_energy(x, beta):
        return beta * potential_fn(x)

    def kinetic_energy(v):
        return 0.5 * chain_sum(v * v)

    def hamiltonian(x, v, beta):
        return potential_energy(x, beta) + kinetic_energy(v)

    force = getattr(potential_fn, "force", None)

    def grad_potential(x, beta):
        """d/dx [beta U(x)]; keeps the graph when x is part of one.  A
        potential with a ``force`` (``ops/wilson.py make_potential_fn``)
        gives it in one call; otherwise autograd differentiates U."""
        with trace.span("l2hmc.force"):
            if force is not None:
                with torch.set_grad_enabled(x.requires_grad):
                    return force(x, beta)
            with torch.enable_grad():
                xg = x if x.requires_grad else x.detach().requires_grad_(True)
                e = torch.sum(potential_energy(xg, beta))
                (g,) = torch.autograd.grad(e, xg,
                                           create_graph=x.requires_grad)
            return g

    def pos_features(x, mask=None):
        """Raw position for 'r1', (cos, sin) for 'u1'."""
        if not periodic:
            return x if mask is None else mask * x
        feats = torch.cat([torch.cos(x), torch.sin(x)], dim=-1)
        if mask is not None:
            feats = torch.cat([mask, mask], dim=-1) * feats
        return feats

    def update_v(params, x, v, g, tau, d_col, d_row, eps, aux,
                 factor=0.5):
        """Direction-fused momentum kick (``factor`` x eps)."""
        with trace.span("l2hmc.vnet"):
            s, t, q = apply_net(params.vnet, pos_features(x), g, tau, aux)
        h_s = factor * eps * s
        a = factor * eps * (torch.exp(eps * q) * g - t)
        e = torch.exp(d_col * h_s)
        v_new = torch.where(d_col > 0, v * e - a, (v + a) * e)
        return v_new, d_row * chain_sum(h_s)

    def update_x(params, x, v, tau, hold_mask, d_col, d_row, eps, aux):
        """Direction-fused position step; ``hold_mask`` part stays fixed.
        'r1': ``x exp(eps s) + b`` forward, ``(x - b) exp(-eps s)``
        backward; 'u1': circle scaling and translation with wrap."""
        with trace.span("l2hmc.xnet"):
            s, t, q = apply_net(params.xnet, v, pos_features(x, hold_mask),
                                tau, aux)
        es = eps * s
        b = eps * (torch.exp(eps * q) * v + t)
        if not periodic:
            e = torch.exp(d_col * es)
            upd = torch.where(d_col > 0, x * e + b, (x - b) * e)
            x_new = hold_mask * x + (1.0 - hold_mask) * upd
            return x_new, d_row * chain_sum((1.0 - hold_mask) * es)
        u = torch.where(d_col > 0, x, _wrap(x - b))
        y, ld = circle_scale(u, d_col * es)
        upd = torch.where(d_col > 0, _wrap(y + b), y)
        x_new = hold_mask * x + (1.0 - hold_mask) * upd
        return x_new, chain_sum((1.0 - hold_mask) * ld)

    def _step_context(params, step, d_row):
        """Each chain reads masks/time at ``step`` (forward) or ``K-1-step``
        (backward); forward X order is hold=m then 1-m, backward reversed."""
        d_col = d_row[:, None]
        idx = torch.where(d_row > 0, step, K - 1 - step).to(torch.int64)
        tau = time_encoding(idx, K)
        masks = params.masks if sp is None else sp.columns(params.masks)
        mask = masks[idx]
        hold1 = torch.where(d_col > 0, mask, 1.0 - mask)
        return d_col, tau, hold1, 1.0 - hold1

    def leapfrog_step(params, x, v, g, beta, step, d_row, eps, aux):
        """One split step: half-kick, the two X sub-updates, the force at
        the new position (returned for the next step), half-kick."""
        d_col, tau, hold1, hold2 = _step_context(params, step, d_row)
        v, ld0 = update_v(params, x, v, g, tau, d_col, d_row, eps, aux)
        x, ld1 = update_x(params, x, v, tau, hold1, d_col, d_row, eps, aux)
        x, ld2 = update_x(params, x, v, tau, hold2, d_col, d_row, eps, aux)
        g = grad_potential(x, beta)
        v, ld3 = update_v(params, x, v, g, tau, d_col, d_row, eps, aux)
        return x, v, g, ld0 + ld1 + ld2 + ld3

    def leapfrog_step_merged(params, x, v, g, beta, step, d_row, eps, aux):
        """One ``merge_v_halves`` step: the boundary kick (a half-kick at
        time 0, else a full kick at ``step - 1/2``), then the two X
        sub-updates and the force at the new position."""
        d_col, tau_x, hold1, hold2 = _step_context(params, step, d_row)
        factor = 0.5 if step == 0 else 1.0
        t_fwd = 0.0 if step == 0 else step - 0.5
        t_bwd = K - 1.0 if step == 0 else K - 0.5 - step
        tau_v = time_encoding(torch.where(d_row > 0, t_fwd, t_bwd), K)
        v, ld0 = update_v(params, x, v, g, tau_v, d_col, d_row, eps, aux,
                          factor=factor)
        x, ld1 = update_x(params, x, v, tau_x, hold1, d_col, d_row, eps, aux)
        x, ld2 = update_x(params, x, v, tau_x, hold2, d_col, d_row, eps, aux)
        return x, v, grad_potential(x, beta), ld0 + ld1 + ld2

    def run_step(body, *args):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(body, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return body(*args)

    def integrate(params, x, v, beta, direction, aux=None):
        """``num_steps`` leapfrog steps; ``direction (B,)`` in {+1,-1}."""
        eps = get_eps(params, cfg)
        if sp is not None:
            eps = sp.enter(eps)
        body = leapfrog_step_merged if cfg.merge_v_halves else leapfrog_step
        g = grad_potential(x, beta)
        sumlogdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for step in range(K):
            x, v, g, ld = run_step(body, params, x, v, g, beta, step,
                                   direction, eps, aux)
            sumlogdet = sumlogdet + ld
        if cfg.merge_v_halves:
            # closing half-kick: trajectory time K-1 forward, 0 backward
            tau_v = time_encoding(torch.where(direction > 0, K - 1.0, 0.0),
                                  K)
            v, ld = update_v(params, x, v, g, tau_v, direction[:, None],
                             direction, eps, aux, factor=0.5)
            sumlogdet = sumlogdet + ld
        return x, v, sumlogdet

    def accept_prob_fn(x0, v0, x1, v1, sumlogdet, beta):
        """``exp(min(H0 - H1 + logdet, 0))`` with NaN -> 0."""
        dh = hamiltonian(x0, v0, beta) - hamiltonian(x1, v1, beta) + sumlogdet
        prob = torch.exp(torch.clamp(dh, max=0.0))
        return torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))

    def _sanitize(x, v, xp, vp):
        """Replace non-finite proposals with the initial state."""
        ok = torch.all(torch.isfinite(xp) & torch.isfinite(vp), dim=-1)
        if sp is not None:
            ok = sp.all_chains(ok)      # finite on every slab or on none
        ok = ok[:, None]
        return torch.where(ok, xp, x), torch.where(ok, vp, v)

    def _accept(x, xp, vp, prob, sumlogdet, u, fwd):
        accept = (u < prob).to(x.dtype)
        x_out = accept[:, None] * xp + (1.0 - accept[:, None]) * x
        return Transition(
            x_proposed=xp, v_proposed=vp, accept_prob=prob, x_out=x_out,
            sumlogdet=sumlogdet, accept_mask=accept,
            forward_frac=torch.mean(fwd.to(torch.float32)))

    def transition_fused(params, x, beta, v, direction, u, aux=None):
        xp, vp, sumlogdet = integrate(params, x, v, beta, direction, aux)
        prob = accept_prob_fn(x, v, xp, vp, sumlogdet, beta)
        xp, vp = _sanitize(x, v, xp, vp)
        return _accept(x, xp, vp, prob, sumlogdet, u, direction > 0)

    def transition_both(params, x, beta, v, direction, u, aux=None):
        """The reference dataflow: integrate forward AND backward from the
        same momenta, keep one per chain (``direction > 0``: forward)."""
        ones = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        xf, vf, ldf = integrate(params, x, v, beta, ones, aux)
        xb, vb, ldb = integrate(params, x, v, beta, -ones, aux)
        pf = accept_prob_fn(x, v, xf, vf, ldf, beta)
        pb = accept_prob_fn(x, v, xb, vb, ldb, beta)
        xf, vf = _sanitize(x, v, xf, vf)
        xb, vb = _sanitize(x, v, xb, vb)
        fwd = (direction > 0).to(x.dtype)
        fc = fwd[:, None]
        xp = fc * xf + (1 - fc) * xb
        vp = fc * vf + (1 - fc) * vb
        prob = fwd * pf + (1 - fwd) * pb
        sumlogdet = fwd * ldf + (1 - fwd) * ldb
        return _accept(x, xp, vp, prob, sumlogdet, u, fwd)

    transition_with = (transition_both if cfg.both_directions
                       else transition_fused)

    def draw(generator, x):
        """``(v, direction, u)`` of one transition (sharded: the global
        momenta's slab columns)."""
        shape = x.shape if sp is None else (x.shape[0], cfg.x_dim)
        v = torch.randn(shape, generator=generator, dtype=x.dtype,
                        device=x.device)
        if sp is not None:
            v = sp.columns(v).contiguous()
        direction = torch.where(
            torch.rand((x.shape[0],), generator=generator,
                       device=x.device) > 0.5, 1.0, -1.0).to(x.dtype)
        u = torch.rand((x.shape[0],), generator=generator, device=x.device)
        return v, direction, u

    def transition(params, x, beta, generator, aux=None):
        return transition_with(params, x, beta, *draw(generator, x), aux=aux)

    def chain_operator_with(params, x, beta, max_compositions: int, n_comp,
                            v, direction, u, aux=None):
        """``n_comp (B,)`` in ``[1, max_compositions]`` full integrations
        per chain, then one MH accept.  Every chain runs
        ``max_compositions`` integrations; a chain's state is frozen once
        its count is spent, and the log-Jacobian sums over its active
        compositions only."""
        xc, vc = x, v
        sumlogdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for i in range(max_compositions):
            active = n_comp > i
            xn, vn, ldn = integrate(params, xc, vc, beta, direction, aux)
            xc = torch.where(active[:, None], xn, xc)
            vc = torch.where(active[:, None], vn, vc)
            sumlogdet = sumlogdet + torch.where(active, ldn,
                                                torch.zeros_like(ldn))
        prob = accept_prob_fn(x, v, xc, vc, sumlogdet, beta)
        xp, vp = _sanitize(x, v, xc, vc)
        return _accept(x, xp, vp, prob, sumlogdet, u, direction > 0)

    def chain_operator(params, x, beta, generator, max_compositions: int,
                       aux=None):
        """Compose a random number ``n_comp ~ U{1..max_compositions}`` per
        chain of full leapfrog integrations before ONE MH accept (the
        reference's ``random_lf_composition``)."""
        n_comp = torch.randint(1, max_compositions + 1, (x.shape[0],),
                               generator=generator, device=x.device)
        return chain_operator_with(params, x, beta, max_compositions, n_comp,
                                   *draw(generator, x), aux=aux)

    return {
        "chain_operator": chain_operator,
        "chain_operator_with": chain_operator_with,
        "transition": transition,
        "transition_with": transition_with,
        "integrate": integrate,
        "hamiltonian": hamiltonian,
        "potential_energy": potential_energy,
        "kinetic_energy": kinetic_energy,
        "accept_prob": accept_prob_fn,
    }
